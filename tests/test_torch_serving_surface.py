"""The port's model server against the reference's, both on the committed
golden-tiny checkpoint (float32, CPU): the chat and models routes, request
IDs, deadlines, the 429's ``Retry-After``, the ``/debug/*``, ``/metrics``,
``/control/incident`` and ``/profiler`` routes; then the engine surface
behind them: deadline stops mid-chunk and mid-decode, round records at
both dispatch depths, ``prewarm``, and the stats keys against the
reference's and the README's table.

Tolerances: greedy text and token ids exact; bodies equal apart from
``id`` and ``created``; record and body shapes compared as key sets
(timings differ)."""

import contextlib
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine import engine as engine_mod
from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY as CFG
from generativeaiexamples_tpu_torch.models.import_hf import load_checkpoint
from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.obs import rounds as obs_rounds
from generativeaiexamples_tpu_torch.serving.model_server import \
    create_server_app
from generativeaiexamples_tpu_torch.serving.openai_api import render_chat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_tiny")
# One request at a time fits the queue (max_queue=1): the routes are
# driven one after another, and a held request fills it for the 429.
ENGINE_KW = dict(max_slots=2, max_input_length=256, max_output_length=64,
                 prefill_buckets=(64, 128, 256), page_size=16,
                 dtype="float32", kv_pool_tokens=None, max_queue=1)
MESSAGES = [{"role": "system", "content": "Answer from the docs only."},
            {"role": "user", "content": "What does the paged KV pool hold?"}]
CHAT = {"messages": MESSAGES, "max_tokens": 12, "temperature": 0}
TIMEOUT = 60


@contextlib.contextmanager
def _serve(app):
    """Run ``app`` on a free local port in a thread; on exit its cleanup
    runs (the retained telemetry's sampler stops, and the engine)."""
    import asyncio

    from aiohttp import web

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


def _call(url, body=None, headers=None, timeout=TIMEOUT):
    """(status, headers, text) of a GET (``body`` None) or a JSON POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read().decode()


def _sse(text):
    events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _strip(body):
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def _keys(d):
    """The nested key structure of a JSON body."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


@pytest.fixture(scope="module")
def golden():
    params = load_checkpoint(GOLDEN, CFG, dtype=torch.float32, device="cpu")
    return params, get_tokenizer(GOLDEN)


@pytest.fixture(scope="module")
def servers(golden, tmp_path_factory):
    """The port's server over the port's engine and the reference's over
    the JAX ``Engine``, both on golden-tiny, each with its own incident
    directory, the cost-drift alert's threshold out of reach."""
    import jax.numpy as jnp

    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    from generativeaiexamples_tpu.serving.model_server import \
        create_server_app as ref_app

    params, tok = golden
    eng = Engine(params, CFG, tok, EngineConfig(**ENGINE_KW), device="cpu")
    jeng = JEngine(jload(GOLDEN, JCFG, dtype=jnp.float32), JCFG,
                   jget(GOLDEN), JConfig(**ENGINE_KW))
    with pytest.MonkeyPatch.context() as mp:
        # CPU rounds run far over the card-sized cost model's prediction,
        # so the drift rule fires once its 30 s "for" has passed, and its
        # incident would join the drill's in /debug/incidents on a slow
        # host: keep it out, as the reference's chaos test does
        # (tests/test_chaos.py). The rules are read when each app is made.
        mp.setenv("ALERT_DRIFT_RATIO_MAX", "1e9")
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("port_run")))
        app = create_server_app(eng, model_name="golden-tiny")
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("ref_run")))
        japp = ref_app(jeng, None, "golden-tiny")
    with _serve(app) as port, _serve(japp) as ref:
        yield {"port": port, "ref": ref, "engines": {"port": eng,
                                                     "ref": jeng}}


def _both(servers, path, body=None, headers=None):
    return {side: _call(servers[side] + path, body, headers)
            for side in ("port", "ref")}


@pytest.mark.parametrize("stream", [False, True])
def test_chat_completions_match_the_reference(servers, golden, stream):
    """Greedy /v1/chat/completions, one body and streamed: the same text,
    usage, object and finish_reason; the text is the engine's greedy text
    of the Llama-2 rendering of the messages."""
    out = _both(servers, "/v1/chat/completions", {**CHAT, "stream": stream})
    bodies = {}
    for side, (status, headers, text) in out.items():
        assert status == 200, (side, text)
        if stream:
            chunks = _sse(text)
            assert {c["object"] for c in chunks} == {"chat.completion.chunk"}
            assert chunks[-1]["choices"][0]["delta"] == {"content": ""}
            assert len({c["id"] for c in chunks}) == 1
            assert headers["X-Request-ID"] == chunks[0]["id"]
            bodies[side] = ("".join(c["choices"][0]["delta"]["content"]
                                    for c in chunks),
                            chunks[-1]["choices"][0]["finish_reason"],
                            [_strip(c) | {"choices": None} for c in chunks])
        else:
            body = json.loads(text)
            assert body["object"] == "chat.completion"
            assert body["id"].startswith("cmpl-")
            bodies[side] = _strip(body)
    assert bodies["port"] == bodies["ref"]
    text = (bodies["port"][0] if stream
            else bodies["port"]["choices"][0]["message"]["content"])
    params, tok = golden
    ref = servers["engines"]["port"].submit(
        tok.encode(render_chat(MESSAGES)),
        SamplingParams(max_tokens=12, top_k=1))
    assert text == ref.text() and len(text) > 5
    assert render_chat(MESSAGES + [{"role": "assistant", "content": "Pages."},
                                   {"role": "user", "content": "More?"}]) == (
        "<s>[INST] <<SYS>>\nAnswer from the docs only.\n<</SYS>>\n\n"
        "What does the paged KV pool hold? [/INST] Pages. </s>"
        "<s>[INST] More? [/INST]")


def test_models_and_embeddings_routes(servers):
    out = _both(servers, "/v1/models")
    assert out["port"][0] == out["ref"][0] == 200
    assert json.loads(out["port"][2]) == json.loads(out["ref"][2]) == {
        "object": "list", "data": [{"id": "golden-tiny", "object": "model",
                                    "owned_by": "generativeaiexamples-tpu"}]}
    out = _both(servers, "/v1/embeddings", {"input": "x"})
    assert out["port"][0] == out["ref"][0] == 501
    assert "no embedding model loaded" in out["port"][2]
    out = _both(servers, "/v1/chat/completions", {"messages": []})
    assert out["port"][0] == out["ref"][0] == 422


@pytest.mark.parametrize("input_type", ["passage", "query"])
def test_embeddings_route_matches_the_reference(input_type):
    """/v1/embeddings over each package's embedding service on the same
    seeded encoder-tiny weights: the same body shape, and vectors within
    1e-5 (the encoders sum in different orders); /v1/models lists the
    embedder. ``build_embedder`` makes the server's default embedder."""
    import jax
    import numpy as np
    from aiohttp import web

    from generativeaiexamples_tpu.embed.encoder import \
        EmbeddingService as JEmbed
    from generativeaiexamples_tpu.models import encoder as jenc
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    from generativeaiexamples_tpu.models.tokenizer import ByteTokenizer as JB
    from generativeaiexamples_tpu.serving.openai_api import \
        add_openai_routes as ref_routes
    from generativeaiexamples_tpu_torch.embed.encoder import EmbeddingService
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.serving.model_server import \
        build_embedder
    from generativeaiexamples_tpu_torch.serving.openai_api import \
        add_openai_routes

    jparams = jenc.init_params(JENC, jax.random.key(0))
    params = enc.encoder_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           ENCODER_TINY)
    app, japp = web.Application(), web.Application()
    add_openai_routes(app, None, "golden-tiny", embed_service=EmbeddingService(
        params, ENCODER_TINY, ByteTokenizer()))
    ref_routes(japp, None, "golden-tiny",
               embed_service=JEmbed(jparams, JENC, JB()))
    body = {"input": ["The paged KV pool holds pages.", "x"],
            "input_type": input_type}
    out = {}
    with _serve(app) as port, _serve(japp) as ref:
        for side, base in (("port", port), ("ref", ref)):
            status, _, text = _call(base + "/v1/embeddings", body)
            assert status == 200, text
            out[side] = json.loads(text)
            status, _, text = _call(base + "/v1/models")
            assert [m["id"] for m in json.loads(text)["data"]] == [
                "golden-tiny", "embeddings"]
        status, _, text = _call(port + "/v1/embeddings", {"input": "one"})
        assert status == 200 and len(json.loads(text)["data"]) == 1
    vecs = {side: np.array([d["embedding"] for d in o["data"]])
            for side, o in out.items()}
    strip = {side: {**o, "data": [{**d, "embedding": None}
                                  for d in o["data"]]}
             for side, o in out.items()}
    assert strip["port"] == strip["ref"]
    assert vecs["port"].shape == (2, ENCODER_TINY.hidden_size)
    np.testing.assert_allclose(vecs["port"], vecs["ref"], atol=1e-5, rtol=0)
    svc = build_embedder(device="cpu")
    assert svc.cfg == ENCODER_TINY and svc.device.type == "cpu"


def test_request_id_echo_duplicate_suffix_and_timeline(servers):
    """A client's X-Request-ID is the completion's id and its timeline's
    key; while a request of that ID is in flight, the next one is
    suffixed as the reference suffixes it. The timeline holds the queue
    wait and the first readback."""
    ids = {}
    for side in ("port", "ref"):
        eng = servers["engines"][side]
        held = eng.flight.begin("client-dup", fresh=True)
        status, headers, text = _call(
            servers[side] + "/v1/completions",
            {"prompt": "Paged KV caching shares", "max_tokens": 4,
             "temperature": 0}, {"X-Request-ID": "client-dup"})
        eng.flight.complete(held)
        assert status == 200
        ids[side] = json.loads(text)["id"]
        _, _, text = _call(servers[side] + "/debug/requests?limit=5")
        snap = json.loads(text)
        tl = next(t for t in snap["completed"]
                  if t["request_id"] == ids[side])
        events = {e["event"] for e in tl["events"]}
        assert {"engine_admit_pickup", "engine_first_readback",
                "engine_ttft", "finish"} <= events, (side, events)
        assert tl["meta"]["finish"] == "length"
        assert tl["meta"]["generated"] == 4 and "slot" in tl["meta"]
        assert _call(servers[side] + "/debug/requests?limit=x")[0] == 400
    assert ids["port"] == ids["ref"] == "client-dup#2"
    status, headers, _ = _call(servers["port"] + "/v1/completions",
                               {"prompt": "x", "max_tokens": 1},
                               {"X-Request-ID": "plain-id"})
    assert headers["X-Request-ID"] == "plain-id"


def _held_engine(eng):
    """Stop ``eng``'s serve loop and keep the routes from starting it:
    submissions stay queued until ``_release`` starts it again."""
    eng.stop()
    eng.start = lambda: None


def _release(eng):
    del eng.start
    eng.start()


def test_a_full_queue_answers_429_with_retry_after(servers, golden):
    """With the queue's one place taken, a chat request is refused with
    429 and a Retry-After of at least a second, on both servers."""
    for side in ("port", "ref"):
        eng = servers["engines"][side]
        _held_engine(eng)
        ids = eng.tokenizer.encode("Continuous batching admits")
        sp = (SamplingParams(max_tokens=2, top_k=1) if side == "port" else
              __import__("generativeaiexamples_tpu.engine", fromlist=["x"])
              .SamplingParams(max_tokens=2, top_k=1))
        held = eng.submit(ids, sp)
        rejected = eng.stats["rejected_full"]
        status, headers, text = _call(servers[side] + "/v1/chat/completions",
                                      CHAT)
        _release(eng)
        held.text()
        assert status == 429, (side, text)
        assert int(headers["Retry-After"]) >= 1
        assert json.loads(text)["error"]["type"] == "rate_limit_error"
        assert eng.stats["rejected_full"] == rejected + 1


def test_an_expired_deadline_finishes_alike(servers):
    """A request whose X-Deadline-Ms passes while it waits in the queue
    is dropped before it takes a slot: the same body and the same
    counters on both servers."""
    bodies, moved = {}, {}
    for side in ("port", "ref"):
        eng = servers["engines"][side]
        before = eng.stats
        _held_engine(eng)
        box = {}
        t = threading.Thread(target=lambda: box.update(out=_call(
            servers[side] + "/v1/chat/completions", CHAT,
            {"X-Deadline-Ms": "30"})))
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while eng.stats["queue_waiting"] == 0:
            assert time.monotonic() < deadline, "the request never queued"
            time.sleep(0.01)
        time.sleep(0.1)
        _release(eng)
        t.join(TIMEOUT)
        status, _, text = box["out"]
        assert status == 200, text
        bodies[side] = _strip(json.loads(text))
        after = eng.stats
        moved[side] = {k: after[k] - before[k] for k in (
            "deadline_queue_drops", "deadline_stops", "prefills")}
    assert bodies["port"] == bodies["ref"]
    assert bodies["port"]["choices"][0]["finish_reason"] == "deadline_queue"
    assert bodies["port"]["usage"]["completion_tokens"] == 0
    assert moved["port"] == moved["ref"] == {
        "deadline_queue_drops": 1, "deadline_stops": 0, "prefills": 0}


def _settled(eng, rec):
    """Wait until no round of ``eng`` is in flight and each of its records
    is complete (other engines of the process share the recorder)."""
    deadline = time.monotonic() + TIMEOUT
    while (eng.stats["dispatch_queue_depth"]
           or not all(r.done for r in rec.records()
                      if r.engine_tag == eng.engine_tag)):
        assert time.monotonic() < deadline, "rounds did not settle"
        time.sleep(0.01)


def test_debug_and_metrics_routes_answer_the_references_shapes(servers):
    """/debug/rounds records and aggregates, /debug/history,
    /debug/alerts, /debug/incidents and /control/incident answer with the
    reference's keys; /metrics renders the round metrics and every stats
    key as a gauge, passes the reference's lint, and its round counter
    moves by the engine's records that /debug/rounds shows completed."""
    port_eng = servers["engines"]["port"]
    _settled(port_eng, port_eng.rounds)

    def metric(text, name):
        m = re.search(rf"^{name} (\S+)$", text, re.M)
        return float(m.group(1)) if m else 0.0

    def done_ids():
        body = json.loads(_call(servers["port"] + "/debug/rounds?limit=10000"
                                f"&engine={port_eng.engine_tag}")[2])
        return {r["round_id"] for r in body["rounds"] if r["done"]}

    ids0 = done_ids()
    scrape0 = _call(servers["port"] + "/metrics")[2]
    _both(servers, "/v1/chat/completions", {**CHAT, "max_tokens": 20})
    _settled(port_eng, port_eng.rounds)
    status, headers, scrape = _call(servers["port"] + "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    from generativeaiexamples_tpu.obs.metrics import lint_prometheus
    assert lint_prometheus(scrape) == []
    for key in engine_mod.engine_stat_keys():
        assert re.search(rf"^engine_{key} ", scrape, re.M), key
    for name in ("engine_round_seconds_count", "engine_round_bw_util",
                 "engine_harvest_wait_ms_avg", "process_rss_bytes",
                 "serve_chat_requests_total"):
        assert re.search(rf"^{name}\b", scrape, re.M), name
    rounds = metric(scrape, "engine_rounds_total") - metric(
        scrape0, "engine_rounds_total")
    assert rounds == len(done_ids() - ids0) > 0

    out = _both(servers, "/debug/rounds?limit=50")
    snaps = {side: json.loads(text) for side, (_, _, text) in out.items()}
    decode = {side: next(r for r in s["rounds"] if r["kind"] == "decode"
                         and r["done"]) for side, s in snaps.items()}
    assert _keys(decode["port"]) == _keys(decode["ref"])
    assert set(snaps["port"]) == set(snaps["ref"])
    assert set(snaps["port"]["aggregates"]) == set(snaps["ref"]["aggregates"])
    rec = decode["port"]
    assert rec["plan"]["decode_steps"] > 0
    assert rec["execution"]["device_ms"] > 0
    assert rec["outcome"]["hbm_bytes_est"] > 0
    assert rec["outcome"]["bw_util"] == 0.0     # no peak on the CPU
    assert rec["engine"] == port_eng.engine_tag
    for path in ("/debug/history?metrics=engine_*", "/debug/alerts",
                 "/debug/incidents"):
        out = _both(servers, path)
        bodies = {side: json.loads(text) for side, (_, _, text) in
                  out.items()}
        assert out["port"][0] == out["ref"][0] == 200, path
        assert set(bodies["port"]) == set(bodies["ref"]), path
    out = _both(servers, "/control/incident", {"reason": "drill"})
    bodies = {side: json.loads(text) for side, (_, _, text) in out.items()}
    assert out["port"][0] == out["ref"][0] == 200
    assert set(bodies["port"]) == set(bodies["ref"])
    assert bodies["port"]["status"] == "captured"
    listing = json.loads(_call(servers["port"] + "/debug/incidents")[2])
    assert listing["count"] == 1 and listing["enabled"]
    bundle = json.loads(_call(servers["port"] + "/debug/incidents?id="
                              + bodies["port"]["id"])[2])
    assert bundle["trigger"]["reason"] == "drill"
    assert bundle["rounds"]["rounds"] and bundle["flight"]["completed"]


def test_profiler_writes_a_trace(servers, tmp_path):
    """POST /profiler/start and /stop around one request write a Chrome
    trace into the request's directory; a second start and a stop with
    nothing running answer 409. Bounded by 60 s of its own."""
    base = servers["port"]
    box = {}

    def run():
        box["conflict_stop"] = _call(base + "/profiler/stop", {})[0]
        box["start"] = _call(base + "/profiler/start",
                             {"dir": str(tmp_path)})
        box["again"] = _call(base + "/profiler/start", {})[0]
        _call(base + "/v1/completions", {"prompt": "Paged KV", "max_tokens":
                                         3, "temperature": 0})
        box["stop"] = _call(base + "/profiler/stop", {})

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the profiler routes did not answer in 60 s"
    assert box["conflict_stop"] == 409 and box["again"] == 409
    assert box["start"][0] == 200
    status, _, text = box["stop"]
    assert status == 200, text
    out = json.loads(text)
    assert out["status"] == "written" and out["dir"] == str(tmp_path)
    trace = json.load(open(out["trace"]))
    assert os.path.dirname(out["trace"]) == str(tmp_path)
    assert trace["traceEvents"]


# ----------------------------------------------------------- engine surface

LONG = ("Paged KV caching shares the pages of a prompt prefix between "
        "requests, so a follow-up that repeats a system prompt skips its "
        "prefill and only the new question is computed.")
CHUNKED_KW = dict(max_slots=2, max_input_length=128, max_output_length=48,
                  prefill_buckets=(32, 64, 128), page_size=16,
                  max_prefill_bucket=32, steps_per_round=4,
                  sched_round_budget_tokens=16, dtype="float32",
                  kv_pool_tokens=None)


def _engine(golden, **kw):
    params, tok = golden
    return Engine(params, CFG, tok, EngineConfig(**{**CHUNKED_KW, **kw}),
                  device="cpu")


def _drive(eng, streams, steps=400):
    for _ in range(steps):
        if all(s.finish_reason for s in streams) and not eng._slots:
            return
        eng._step()
    raise AssertionError("the streams did not finish")


def test_a_deadline_between_chunks_frees_every_page_and_prefix_ref(golden):
    """A request past its deadline between two prompt chunks stops
    ("deadline", counted in deadline_stops): its slot, its pages and the
    prefix-cache references of its cached prefix all return."""
    tok = golden[1]
    eng = _engine(golden, dispatch_depth=1)
    warm = eng.submit(tok.encode(LONG), SamplingParams(max_tokens=2,
                                                       top_k=1))
    _drive(eng, [warm])
    cache = eng._prefix_cache
    free0, cached = eng.stats["free_pages"], cache.cached_pages
    assert cache.idle_pages == cached > 0
    s = eng.submit(tok.encode(LONG + " Then the scheduler grants chunks "
                              "of the new question page by page."),
                   SamplingParams(max_tokens=4, top_k=1),
                   deadline_t=time.monotonic() + 3600)
    for _ in range(20):
        eng._step()
        req = next(iter(eng._slots.values()), None)
        if req is not None and req.pf and req.pf_pos > req.pf["start_tok"]:
            break
    assert not req.prefill_done and req.cache_refs
    assert cache.idle_pages < cached            # the hit holds its refs
    req.deadline_t = time.monotonic() - 1
    eng._step()
    assert s.finish_reason == "deadline" and s.token_ids == []
    st = eng.stats
    assert st["deadline_stops"] == 1 and st["active_slots"] == 0
    assert st["free_pages"] == free0 and cache.idle_pages == cache.cached_pages
    assert s.timeline.done and s.timeline.meta["finish"] == "deadline"


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("stop", ["cancelled", "deadline"])
def test_a_stop_between_chunks_completes_its_round_records(golden, depth,
                                                           stop):
    """An admission cancelled or past its deadline between two prompt
    chunks, on an otherwise idle engine, leaves no round record open: the
    records of its chunk rounds complete at the stop (on the harvest
    thread at depth 2), and their round_ms excludes the idle time that
    follows until an unrelated request is served."""
    tok = golden[1]
    eng = _engine(golden, dispatch_depth=depth)
    recorder = eng.rounds = obs_rounds.RoundRecorder(cap=512)
    if depth > 1:
        eng._start_harvest(depth)
    try:
        s = eng.submit(tok.encode(LONG), SamplingParams(max_tokens=4,
                                                        top_k=1),
                       deadline_t=time.monotonic() + 3600)
        for _ in range(20):
            eng._step()
            req = next(iter(eng._slots.values()), None)
            if req is not None and req.pf and req.pf_pos > 16:
                break
        assert not req.prefill_done and req.pf_pos < len(req.prompt_ids)
        if stop == "cancelled":
            s.cancel()
        else:
            req.deadline_t = time.monotonic() - 1
        eng._step()
        assert s.finish_reason == stop and s.token_ids == []
        _settled(eng, recorder)
        chunks = recorder.records()
        assert len(chunks) >= 2 and all(r.done and r.kind == "prefill"
                                        for r in chunks)
        idle = 1.0
        time.sleep(idle)
        for _ in range(5):
            eng._step()                 # idle steps complete nothing more
        b = eng.submit(tok.encode("Paged KV"), SamplingParams(max_tokens=2,
                                                              top_k=1))
        deadline = time.monotonic() + TIMEOUT
        while not b.finish_reason or eng._slots:
            assert time.monotonic() < deadline, "the request did not finish"
            if not eng._step():
                time.sleep(0.002)
        _settled(eng, recorder)
    finally:
        eng.stop()
    assert all(r.done for r in recorder.records())
    assert all(r.round_ms < idle * 1e3 for r in chunks), [
        r.round_ms for r in chunks]
    assert eng.stats["rounds_completed"] == len(recorder.records())
    assert eng.stats["deadline_stops"] == (stop == "deadline")


@pytest.mark.parametrize("depth", [1, 2])
def test_a_deadline_mid_decode_delivers_the_references_prefix(golden,
                                                              servers, depth):
    """A deadline that passes after the 5th token stops the request at
    the next harvested token: its tokens are the JAX engine's first 6
    (the noticing token is kept, its text not emitted), none past it,
    though later tokens of that round and the round in flight exist."""
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    tok = golden[1]
    ids = tok.encode("Continuous batching admits")
    jeng = servers["engines"]["ref"]
    jeng.start()
    ref = jeng.submit(ids, JParams(max_tokens=24, top_k=1, ignore_eos=True))
    ref.text()
    want = ref.token_ids
    eng = _engine(golden, dispatch_depth=depth)
    real = eng._emit_token

    def emit(req, token, now):
        real(req, token, now)
        if len(req.stream.token_ids) == 5:
            req.deadline_t = time.monotonic() - 1

    eng._emit_token = emit
    with eng:
        s = eng.submit(ids, SamplingParams(max_tokens=24, top_k=1,
                                           ignore_eos=True),
                       deadline_t=time.monotonic() + 3600)
        text = s.text()
        deadline = time.monotonic() + TIMEOUT
        while eng.stats["active_slots"] or eng.stats["dispatch_queue_depth"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    assert s.finish_reason == "deadline"
    assert s.token_ids == want[:6] and len(want) == 24
    assert text == tok.decode(want[:5])
    st = eng.stats
    assert st["deadline_stops"] == 1 and st["decode_steps"] >= 8
    assert st["free_pages"] == st["pool_pages"]


@pytest.mark.parametrize("depth", [1, 2])
def test_round_records_complete_on_the_harvesting_thread(golden, depth):
    """Every planned round's record completes. Its parts are read back
    and completed at depth 2 on the harvest thread, at depth 1 on the
    serve thread (a record whose parts were all read before the serve
    thread sealed it finalizes at the seal). Their tokens add up to the
    tokens delivered, their prefill tokens to the prompts, and mixed,
    prefill and decode rounds all appear."""
    tok = golden[1]
    eng = _engine(golden, dispatch_depth=depth)
    recorder = eng.rounds = obs_rounds.RoundRecorder(cap=512)
    threads = []
    real = recorder.complete_part

    def complete_part(rec, **kw):
        threads.append(threading.current_thread().name)
        real(rec, **kw)

    recorder.complete_part = complete_part
    prompts = [tok.encode("Continuous batching admits"), tok.encode(LONG)]
    with eng:
        a = eng.submit(prompts[0], SamplingParams(max_tokens=20, top_k=1,
                                                  ignore_eos=True))
        while len(a.token_ids) < 2:
            time.sleep(0.002)
        b = eng.submit(prompts[1], SamplingParams(max_tokens=6, top_k=1,
                                                  ignore_eos=True))
        for s in (a, b):
            s.text()
        _settled(eng, eng.rounds)
    recs = eng.rounds.records()
    assert recs and all(r.done for r in recs)
    assert {r.kind for r in recs} >= {"decode", "prefill", "mixed"}
    assert sum(r.tokens_emitted + r.first_tokens for r in recs) == 26
    assert sum(r.prefill_tokens for r in recs) == sum(map(len, prompts))
    decode = [r for r in recs if r.decode_steps]
    assert all(r.device_ms > 0 and r.hbm_bytes > 0 and r.modeled_ms > 0
               for r in decode)
    where = "engine-harvest" if depth == 2 else "engine-loop"
    assert set(threads) == {where}
    assert len(threads) == sum(r._parts for r in recs)
    assert eng.stats["rounds_completed"] == len(recs)
    assert eng.stats["first_readbacks"] >= 1
    assert eng.stats["sched_cost_drift_ratio"] > 0


def test_prewarm_serves_and_scrubs_its_dummies(golden):
    """prewarm serves the worst-case request and the two short streams
    through the loop (both ladder rungs run), leaves the engine stopped
    with every slot free, and counts no request."""
    eng = _engine(golden, max_slots=3)
    eng.prewarm()
    st = eng.stats
    assert st["requests"] == 0 and st["tokens_generated"] > 0
    assert eng._thread is None and st["active_slots"] == 0
    B, steps = 3, st["decode_steps"]
    assert st["sampler_rows_skipped"] > 0
    assert st["sampler_rows_sampled"] > steps       # the 3-row rung ran
    done = {t["request_id"] for t in eng.flight.snapshot(200)["completed"]}
    assert {"engine-prewarm", "engine-prewarm-b0", "engine-prewarm-b1"} \
        <= {r.split("#")[0] for r in done}
    s = eng.submit(golden[1].encode("x"), SamplingParams(max_tokens=2))
    _drive(eng, [s])
    assert eng.stats["requests"] == 1 and B == eng.cfg.max_slots


@pytest.mark.parametrize("server", ["model", "chain"])
@pytest.mark.parametrize("close_engine", [False, True])
def test_server_shutdown_closes_the_engine_when_asked(golden, server,
                                                      close_engine):
    """With ``close_engine`` (both servers' CLIs pass it) both
    servers' shutdown closes their in-process engine: its parameters and
    state are dropped, and a second close does nothing. Otherwise the
    model server stops its engine, the chain server leaves it running,
    and it serves on after the app."""
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import \
        from_dict
    eng = _engine(golden)
    if server == "model":
        app = create_server_app(eng, model_name="golden",
                                close_engine=close_engine)
    else:
        cfg = from_dict(AppConfig, {"embeddings": {
            "model_engine": "hash", "dimensions": 32}})
        bot = QAChatbot(llm=EngineLLM(eng), embedder=HashEmbedder(dim=32),
                        config=cfg, fused_rag=False)
        app = create_app(bot, config=cfg, close_engine=close_engine)
    with _serve(app) as base:
        with urllib.request.urlopen(base + "/health",
                                    timeout=TIMEOUT) as resp:
            assert resp.status == 200
    assert (eng._thread is None) == (server == "model" or close_engine)
    if close_engine:
        assert eng.params is None and eng._state is None
        eng.close()
    else:
        eng.stop()
        s = eng.submit(golden[1].encode("x"), SamplingParams(max_tokens=2))
        _drive(eng, [s])
        assert len(s.token_ids) == 2
        eng.close()
        assert eng.params is None


def test_chain_server_cli_closes_its_engine(golden, monkeypatch, tmp_path):
    """The chain server's CLI owns the example it builds: its app closes
    the example's in-process engine at shutdown."""
    from aiohttp import web

    from generativeaiexamples_tpu_torch.chains import server as chain_server
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import \
        from_dict
    eng = _engine(golden)
    cfg = from_dict(AppConfig, {"embeddings": {
        "model_engine": "hash", "dimensions": 32}})

    class Example(QAChatbot):
        def __init__(self):
            super().__init__(llm=EngineLLM(eng),
                             embedder=HashEmbedder(dim=32), config=cfg,
                             fused_rag=False)

    apps = []
    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path))
    monkeypatch.setattr(chain_server, "discover_example",
                        lambda spec: Example)
    monkeypatch.setattr(web, "run_app", lambda app, **kw: apps.append(app))
    chain_server.main(["--upload-dir", str(tmp_path / "up")])
    with _serve(apps[0]) as base:
        with urllib.request.urlopen(base + "/health",
                                    timeout=TIMEOUT) as resp:
            assert resp.status == 200
    assert eng._thread is None
    assert eng.params is None and eng._state is None


def test_prewarm_shrinks_the_pool_when_the_card_runs_out(golden):
    """An out-of-memory error in prewarm's serve shrinks the pool by the
    reference's rule and rebuilds the engine at that size; the retry
    serves. The failed serve's error is dropped, its tracebacks cleared,
    before the rebuild. The floor is one request's pages."""
    eng = _engine(golden, max_slots=4)
    n0 = eng.stats["pool_pages"]
    assert n0 == 4 * eng._pmax
    real, calls, errors, at_rebuild = eng._decode_round, [], [], []

    def failing(*args):
        calls.append(1)
        if len(calls) == 1:
            errors.append(torch.cuda.OutOfMemoryError(
                "CUDA out of memory (test)"))
            raise errors[0]
        return real(*args)

    rebuild = eng._rebuild

    def checked():
        at_rebuild.append((eng._fatal, errors[0].__traceback__))
        rebuild()

    eng._decode_round, eng._rebuild = failing, checked
    eng.prewarm()
    assert eng.stats["pool_pages"] == int(n0 * 0.8) == 35
    assert len(calls) > 1 and eng._fatal is None
    assert at_rebuild == [(None, None)]
    s = eng.submit(golden[1].encode("Paged KV"), SamplingParams(max_tokens=3,
                                                                top_k=1))
    _drive(eng, [s])
    assert len(s.token_ids) == 3
    # At the floor a further shrink would go below one request: it raises.
    small = _engine(golden, kv_pool_tokens=eng._pmax * 16)
    small._decode_round = lambda *a: (_ for _ in ()).throw(
        torch.cuda.OutOfMemoryError("CUDA out of memory (test)"))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        small.prewarm()


# Keys of the reference's stats for features the port has not ported: no
# key, rather than a constant 0. None since the fleet tier brought the
# KV tier's cross-replica transfer and handoff exports.
UNPORTED = ()
PORT_ONLY = {"decode_rounds", "prefill_dispatches", "prefill_chunks",
             "rag_admissions", "harvest_emit_ms", "active_slots",
             "free_pages", "pool_pages"}


def test_stats_keys_are_the_references_less_unported_plus_port_only(golden):
    from generativeaiexamples_tpu.engine.engine import \
        engine_stat_keys as ref_keys
    want = {k for k in ref_keys() if not k.startswith(UNPORTED)} | PORT_ONLY
    assert set(engine_mod.engine_stat_keys()) == want
    assert len(engine_mod.engine_stat_keys()) == len(want)
    eng = _engine(golden)
    assert set(eng.stats) == want
    assert not PORT_ONLY & set(ref_keys())


def test_the_readme_lists_every_port_only_stats_key():
    """The README's port section has a row for each port-only stats key
    (its ``engine_*`` gauge), and no row for a key the engine lacks."""
    text = open(os.path.join(ROOT, "README.md"), encoding="utf-8").read()
    section = text[text.index("## PyTorch/CUDA port"):]
    table = section[section.index("| Stats key"):]
    table = table[:table.index("\n\n")]
    rows = set(re.findall(r"^\| `([a-z_0-9]+)` \|", table, re.M))
    assert rows == PORT_ONLY
    assert rows <= set(engine_mod.engine_stat_keys())
