"""The port's cross-replica KV page transfer (the fleet half of
``engine/kv_tier.py``) against the JAX package on the CPU: the transfer
cases of the reference's ``tests/test_kv_tier.py``.

- ``fetch_blocks`` and ``push_blob`` are bounded: a hung transfer (the
  ``kv.transfer`` fault point) or a dead peer answers None/False within
  the timeout; a corrupt blob from a donor is counted and placed cold.
- The donor allow-list decides as the reference's, boundary rule included.
- A donor's answer lands only the blocks the requester asked for.
- ``export_handoff`` keeps the pages resident and exports the prompt's
  whole chain (the JAX engine's hash chain).
- Cross-replica transfer end to end: a replica hinted at a donor (a port
  replica or a JAX one) fetches its pages over real HTTP and restores
  them, token for token as cold recompute; and through the port router
  with ``ROUTER_KV_TRANSFER``.
- Donor selection in the router's table agrees with the reference's.
- A hung donor places the request cold.
"""

import asyncio
import contextlib
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.server import create_app
from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine import kv_tier
from generativeaiexamples_tpu_torch.engine.kv_tier import (BlockRecord,
                                                           fetch_blocks,
                                                           from_blob, to_blob)
from generativeaiexamples_tpu_torch.engine.prefix_cache import hash_blocks
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.router.server import create_router_app
from generativeaiexamples_tpu_torch.router.table import ReplicaTable
from generativeaiexamples_tpu_torch.utils import faults
from generativeaiexamples_tpu_torch.utils.errors import EngineError

PAGE = 16
CFG_KW = dict(vocab_size=259 + 5, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position_embeddings=256)
CFG = LlamaConfig(**CFG_KW)
ENGINE_KW = dict(max_slots=2, max_input_length=64, max_output_length=16,
                 prefill_buckets=(32, 64), page_size=PAGE, dtype="float32",
                 kv_pool_tokens=96, steps_per_round=4)
SP = SamplingParams(max_tokens=4, top_k=1, ignore_eos=True)
DEAD = "http://127.0.0.1:1"
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("KV_HOST_POOL_TOKENS", "KV_TRANSFER_ALLOW", "ENGINE_ROLE",
                 "ENGINE_SPEC_DECODE", "SCHED_PROFILE_JSON",
                 "ROUTER_KV_TRANSFER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy)."""
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    jparams = jllama.init_params(JL(**CFG_KW), jax.random.key(31),
                                 dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu", torch.float32, cfg=CFG)


def _build(params, host_tokens=4096, **kw):
    return Engine(params[1], CFG, ByteTokenizer(), EngineConfig(
        **{**ENGINE_KW, "kv_host_pool_tokens": host_tokens, **kw}),
        device="cpu")


def _jax_build(params, host_tokens=4096):
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    return JEngine(params[0], JL(**CFG_KW), JTok(), JConfig(
        **ENGINE_KW, kv_host_pool_tokens=host_tokens))


def _prompt(seed, n):
    return [(seed * 31 + i * 7) % 250 + 3 for i in range(n)]


def _greedy_reference(params, prompt_ids, n_steps):
    ids = list(prompt_ids)
    with torch.no_grad():
        for _ in range(n_steps):
            logits, _ = llama.apply(params[1], CFG, torch.tensor([ids]),
                                    torch.arange(len(ids))[None])
            ids.append(int(logits[0, -1].argmax()))
    return ids[len(prompt_ids):]


@contextlib.contextmanager
def _serve(app):
    """Run ``app`` on a free local port on a thread of its own (the
    engine's fetch is a blocking call on the caller's thread)."""
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
    assert started.wait(TIMEOUT), "the server did not start"
    try:
        yield f"http://127.0.0.1:{box['port']}"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(TIMEOUT)


@contextlib.contextmanager
def _donor_hint(url):
    token = kv_tier.bind_transfer_source(url)
    try:
        yield
    finally:
        kv_tier.unbind_transfer_source(token)


# --------------------------------------------------------- bounded legs

def test_fetch_blocks_hang_and_dead_donor_are_bounded():
    faults.set_plan("kv.transfer=hang")
    t0 = time.monotonic()
    assert fetch_blocks(DEAD, [b"x" * 16], timeout_s=0.4) is None
    assert time.monotonic() - t0 < 3.0   # the timeout, not the hang's
    assert faults.fired("kv.transfer") >= 1
    faults.clear()
    assert fetch_blocks(DEAD, [b"x" * 16], timeout_s=0.5) is None
    assert fetch_blocks(DEAD, [], timeout_s=0.5) is None


def test_push_blob_hang_and_dead_target_are_bounded():
    faults.set_plan("kv.transfer=hang")
    t0 = time.monotonic()
    assert kv_tier.push_blob(DEAD, b"x", timeout_s=0.4) is False
    assert time.monotonic() - t0 < 3.0
    assert faults.fired("kv.transfer") >= 1
    faults.clear()
    assert kv_tier.push_blob(DEAD, b"x", timeout_s=0.5) is False
    assert kv_tier.push_blob(DEAD, b"", timeout_s=0.5) is False


def test_corrupt_donor_blob_is_counted_and_placed_cold(params):
    """A donor whose blob fails its CRC: the fetch answers None, the
    engine counts kv_restore_corrupt and prefills cold, token for token
    as recompute; a donor answering 500 costs nothing but the fetch."""
    target = _prompt(13, 2 * PAGE)
    good = to_blob([BlockRecord(h, None, {"k": torch.ones(2, 2)})
                    for h in hash_blocks(target, PAGE)],
                   {"page_size": PAGE})
    bad = bytearray(good)
    bad[-3] ^= 0xFF
    seen = []

    async def pages(request):
        seen.append(request.query["hashes"])
        if len(seen) > 1:
            return web.Response(status=500)
        return web.Response(body=bytes(bad),
                            content_type="application/octet-stream")

    app = web.Application()
    app.router.add_get("/control/kv_pages", pages)
    eng = _build(params)
    with _serve(app) as url, eng:
        corrupt = []
        assert fetch_blocks(url, hash_blocks(target, PAGE), timeout_s=5,
                            on_corrupt=lambda: corrupt.append(1)) is None
        assert corrupt == [1]
        seen.clear()
        with _donor_hint(url):
            stream = eng.submit(target, SP)
        stream.text()
        assert seen == [",".join(h.hex() for h in hash_blocks(target,
                                                              PAGE))]
        with _donor_hint(url):
            again = eng.submit(_prompt(14, 2 * PAGE), SP)
        again.text()
    assert eng.stats["kv_restore_corrupt"] == 1
    assert eng.stats["kv_tier_transfer_pages"] == 0
    assert stream.token_ids == _greedy_reference(params, target, 4)


# ---------------------------------------------------------- trust rules

_ALLOW = ("", "http://10.0.3.7, http://replica-2:8081",
          "http://replica-1", "http://replica-1/", "http://h:")
_URLS = ("http://anything", "http://10.0.3.7:8081", "http://10.0.3.7/x",
         "http://10.0.3.7", "http://replica-2:8081",
         "http://replica-2:8081/a", "http://attacker.example",
         "http://10.0.3.71:8081", "http://replica-2.attacker.example",
         "http://replica-1", "http://replica-1:80",
         "http://replica-1.attacker.example", "http://h:9", "http://hx")


@pytest.mark.parametrize("allow", _ALLOW)
def test_donor_allowlist_matches_the_reference(monkeypatch, allow):
    from generativeaiexamples_tpu.engine import kv_tier as jtier
    monkeypatch.setenv("KV_TRANSFER_ALLOW", allow)
    for url in _URLS:
        assert kv_tier.donor_allowed(url) == jtier.donor_allowed(url), url
    if allow.startswith("http://10.0.3.7"):
        assert kv_tier.donor_allowed("http://10.0.3.7:8081")
        assert not kv_tier.donor_allowed("http://10.0.3.71:8081")
        assert not kv_tier.donor_allowed("http://replica-2.attacker.example")
    if allow == "http://replica-1":
        assert not kv_tier.donor_allowed("http://replica-1.attacker.example")


def test_disallowed_donor_is_never_contacted(params, monkeypatch):
    monkeypatch.setenv("KV_TRANSFER_ALLOW", "http://replica-1")
    called = []
    monkeypatch.setattr(kv_tier, "fetch_blocks",
                        lambda *a, **k: called.append(a))
    eng = _build(params)
    with eng, _donor_hint("http://replica-1.attacker.example"):
        eng.submit(_prompt(15, 2 * PAGE), SP).text()
    assert not called
    assert eng.stats["kv_tier_transfer_pages"] == 0


def test_transfer_rejects_unrequested_blocks(params, monkeypatch):
    """A donor's answer lands only the blocks the requester asked for:
    anything else could poison unrelated prefixes in the host store."""
    eng = _build(params)
    target = _prompt(11, 2 * PAGE)
    hashes = hash_blocks(target, PAGE)
    rogue = BlockRecord(b"R" * 16, None, {"k": torch.zeros(2, 2)})
    good = BlockRecord(hashes[0], None, {"k": torch.zeros(2, 2)})
    monkeypatch.setattr(kv_tier, "fetch_blocks",
                        lambda url, missing, **kw:
                        (dict(eng._kv_tier.meta), [rogue, good]))
    req = SimpleNamespace(prompt_ids=target, block_hashes=None,
                          stream=SimpleNamespace(timeline=None))
    with _donor_hint("http://donor"):
        eng._transfer_prefetch(req)
    assert eng._kv_tier.store.has(hashes[0])
    assert not eng._kv_tier.store.has(b"R" * 16)
    assert eng.stats["kv_tier_transfer_pages"] == 1


def test_transfer_rejects_another_geometry(params, monkeypatch):
    eng = _build(params)
    target = _prompt(16, 2 * PAGE)
    hashes = hash_blocks(target, PAGE)
    monkeypatch.setattr(kv_tier, "fetch_blocks",
                        lambda url, missing, **kw: (
                            dict(eng._kv_tier.meta, page_size=999),
                            [BlockRecord(hashes[0], None,
                                         {"k": torch.zeros(2, 2)})]))
    req = SimpleNamespace(prompt_ids=target, block_hashes=None,
                          stream=SimpleNamespace(timeline=None))
    with _donor_hint("http://donor"):
        eng._transfer_prefetch(req)
    assert not eng._kv_tier.store.has(hashes[0])
    assert eng.stats["kv_tier_transfer_pages"] == 0


# ------------------------------------------------------ the donor side

def test_export_handoff_keeps_pages_resident(params):
    """Unlike suspend, export_handoff leaves the pages resident (the donor
    still answers pulls for the prefix) and its blob carries the whole
    chain, hashed as the JAX engine hashes it."""
    from generativeaiexamples_tpu.engine.prefix_cache import \
        hash_blocks as jhash
    eng = _build(params)
    target = _prompt(12, 3 * PAGE)
    with eng:
        eng.submit(target, SP).text()
        cached = eng._prefix_cache.cached_pages
        blob, n = eng.export_handoff(target)
        assert n == 3
        assert eng._prefix_cache.cached_pages == cached
        meta, recs = from_blob(blob)
        assert [r.hash for r in recs] == hash_blocks(target, PAGE) \
            == jhash(target, PAGE)
        assert meta["page_size"] == PAGE
        for rec in recs:
            pg = eng._prefix_cache.page_of(rec.hash)
            for name, pool in eng._state["cache"].items():
                assert torch.equal(rec.arrays[name], pool[:, pg])
        assert eng.export_handoff(_prompt(99, 2 * PAGE)) is None
    assert eng.stats["kv_tier_export_pages"] == 3
    with pytest.raises(EngineError, match="disabled"):
        _build(params, host_tokens=0).export_handoff(target)


# --------------------------------------------------- transfer end to end

@pytest.mark.parametrize("donor", ["port", "jax"])
def test_cross_replica_transfer_end_to_end(params, donor):
    """Donor A serves a prompt; replica B, hinted as the chain server
    hints it from X-KV-Transfer-From, fetches A's pages over a real
    /control/kv_pages and restores them at admission, token for token as
    cold recompute. A is a port replica or the JAX package's."""
    target = _prompt(8, 3 * PAGE)
    if donor == "port":
        a = _build(params)
        app = create_app(SimpleNamespace(llm=SimpleNamespace(engine=a)))
    else:
        from generativeaiexamples_tpu.chains.server import \
            create_app as japp
        a = _jax_build(params)
        app = japp(SimpleNamespace(llm=SimpleNamespace(engine=a)))
    b = _build(params)
    with a, b:
        cold = a.submit(target, SP)
        cold.text()
        with _serve(app) as url, _donor_hint(url):
            warm = b.submit(target, SP)
        warm.text()
    stats = b.stats
    assert stats["kv_tier_transfer_pages"] == 3
    assert stats["kv_tier_restore_pages"] == 2   # the tail recomputed
    assert warm.token_ids == cold.token_ids \
        == _greedy_reference(params, target, 4)
    assert a.stats["kv_tier_host_pages"] == 3    # the export warmed A


def test_router_driven_transfer(params):
    """``ROUTER_KV_TRANSFER``: the router placed a prompt on one replica;
    that replica drains (no new placements, still a donor), so the same
    prompt lands on its sibling with the first named in
    ``X-KV-Transfer-From``, and the sibling pulls the pages over
    ``/control/kv_pages``. The text equals the first answer."""
    import os

    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import \
        from_dict
    # A short template: the prompt fits this geometry's 256 positions.
    cfg = from_dict(AppConfig, {
        "embeddings": {"model_engine": "hash", "dimensions": 32},
        "prompts": {"chat_template": "{context_str} {query_str}"}})
    kw = dict(max_input_length=224, kv_pool_tokens=1024,
              prefill_buckets=(64,), max_prefill_bucket=64)
    engines = {"r0": _build(params, **kw), "r1": _build(params, **kw)}
    body = {"question": "Which words repeat? " + " ".join(
        "".join(chr(97 + (i * j + 3) % 26) for j in range(5))
        for i in range(20)), "use_knowledge_base": False, "num_tokens": 6}

    def snap(name):
        return obs_metrics.REGISTRY.snapshot().get(name, 0.0)

    async def fn():
        servers = {n: TestServer(create_app(QAChatbot(
            llm=EngineLLM(e), embedder=HashEmbedder(dim=32), config=cfg,
            fused_rag=False), config=cfg)) for n, e in engines.items()}
        for srv in servers.values():
            await srv.start_server()
        urls = {n: f"http://127.0.0.1:{srv.port}"
                for n, srv in servers.items()}
        os.environ["ROUTER_KV_TRANSFER"] = "1"
        try:
            app = create_router_app(sorted(urls.items()), heartbeat_s=30,
                                    run_heartbeat=False)
        finally:
            del os.environ["ROUTER_KV_TRANSFER"]
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await client.post("/control/heartbeat")
            resp = await client.post("/generate", json=body)
            first = (await resp.read()).decode()
            assert resp.status == 200 and "[error]" not in first
            donor = resp.headers["X-Routed-Replica"]
            other = "r1" if donor == "r0" else "r0"
            drain = TestClient(servers[donor])
            assert (await drain.post("/control/drain")).status == 200
            await client.post("/control/heartbeat")
            hints = snap("router_kv_transfer_hints_total")
            resp = await client.post("/generate", json=body)
            second = (await resp.read()).decode()
            assert resp.status == 200
            assert resp.headers["X-Routed-Replica"] == other
            assert snap("router_kv_transfer_hints_total") == hints + 1
            return donor, other, first, second
        finally:
            await client.close()
            for srv in servers.values():
                await srv.close()

    with engines["r0"], engines["r1"]:
        loop = asyncio.new_event_loop()
        try:
            donor, other, first, second = loop.run_until_complete(fn())
        finally:
            loop.close()
    assert second == first
    assert engines[other].stats["kv_tier_transfer_pages"] > 0
    assert engines[other].stats["kv_tier_restore_pages"] > 0
    assert engines[donor].stats["kv_tier_transfer_pages"] == 0


def test_transfer_donor_selection_matches_the_reference():
    """A sibling whose sketch covers the prompt head strictly better than
    the chosen replica (by at least min_blocks) is the donor; unreachable
    siblings never are, draining ones still are. The port's table and
    the reference's name the same donor at every step."""
    from generativeaiexamples_tpu.router.table import \
        ReplicaTable as JTable
    answers = []
    for cls in (ReplicaTable, JTable):
        table = cls()
        table.add("r0", "http://r0")
        r1 = table.add("r1", "http://r1")
        blocks = table.affinity_blocks("s" * 400)
        got = [table.transfer_donor(blocks, chosen="r0")]
        table.record_placement(r1, blocks)
        got += [table.transfer_donor(blocks, chosen="r0"),
                table.transfer_donor(blocks, chosen="r1"),
                table.transfer_donor(blocks[:1], chosen="r0", min_blocks=2)]
        table.mark_unreachable("r1")
        got.append(table.transfer_donor(blocks, chosen="r0"))
        table.update_health("r1", ok=True, ready=False,
                            body={"draining": True})
        got.append(table.transfer_donor(blocks, chosen="r0"))
        answers.append(got)
    assert answers[0] == answers[1] == [None, "http://r1", None, None, None,
                                        "http://r1"]


def test_chaos_transfer_hang_places_cold(params):
    """kv.transfer=hang on the requester: submit pays the bounded fetch
    timeout, then the request prefills cold."""
    eng = _build(params)
    eng._kv_tier.transfer_timeout_s = 0.3
    target = _prompt(4, 2 * PAGE)
    faults.set_plan("kv.transfer=hang")
    try:
        with eng, _donor_hint(DEAD):
            t0 = time.monotonic()
            stream = eng.submit(target, SP)
            submit_s = time.monotonic() - t0
            stream.text()
    finally:
        faults.clear()
    assert submit_s < 5.0, submit_s
    assert stream.finish_reason == "length"
    assert stream.token_ids == _greedy_reference(params, target, 4)
    assert eng.stats["kv_tier_transfer_pages"] == 0


def test_chain_server_reads_a_blob_as_large_as_the_host_tier(params):
    """``/control/kv_resume`` takes any blob the receiver's host tier can
    hold: the body limit is 100 MiB, or the tier's bytes plus 1 MiB of
    header when larger (a 2000-token prefix of a 7B int8 pool is about
    0.5 GB)."""
    from generativeaiexamples_tpu_torch.chains.server import _max_body_bytes
    small, none = _build(params), _build(params, host_tokens=0)
    assert _max_body_bytes(SimpleNamespace(
        llm=SimpleNamespace(engine=none))) == 100 * 1024 ** 2
    assert _max_body_bytes(SimpleNamespace()) == 100 * 1024 ** 2
    small._kv_tier.store.capacity_bytes = 600 * 10 ** 6
    ex = SimpleNamespace(llm=SimpleNamespace(engine=small))
    assert _max_body_bytes(ex) == 600 * 10 ** 6 + (1 << 20)
    assert create_app(ex)._client_max_size == 600 * 10 ** 6 + (1 << 20)
