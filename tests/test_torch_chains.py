"""The port's chain layer against the JAX package's: the config system, the
fault plans and breakers, the splitter, readers and LLM clients, the
developer RAG example and the chain server's routes; then the slice as a
whole — two chain servers on the committed golden-tiny checkpoint
(float32, CPU), each over its package's engine through ``EngineLLM``,
with the same seeded ``encoder-tiny`` weights and an exact store, fed
the same three ``docs/*.md`` files through ``/uploadDocument``.

Tolerances: texts, ids, sources and statuses exact; retrieval scores
within 1e-5 (the two encoders sum in different orders, atol 1e-5 on
unit vectors)."""

import asyncio
import contextlib
import io
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
import zipfile
import zlib

import numpy as np
import pytest

import aiohttp
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.examples.developer_rag import (
    DEGRADED_NOTICE, QAChatbot)
from generativeaiexamples_tpu_torch.chains.llm import (EchoLLM, EngineLLM,
                                                       OpenAICompatLLM,
                                                       get_llm)
from generativeaiexamples_tpu_torch.chains.readers import (read_document,
                                                           read_pdf)
from generativeaiexamples_tpu_torch.chains.server import (DRAIN_STATE,
                                                          GENERATE_BREAKER,
                                                          create_app,
                                                          discover_example)
from generativeaiexamples_tpu_torch.chains.splitter import (
    TokenTextSplitter, cap_context)
from generativeaiexamples_tpu_torch.embed.encoder import (EmbeddingService,
                                                          HashEmbedder)
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.obs import flight as obs_flight
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.retrieval.docstore import DocumentIndex
from generativeaiexamples_tpu_torch.retrieval.exact import ExactStore
from generativeaiexamples_tpu_torch.utils import faults, resilience
from generativeaiexamples_tpu_torch.utils.app_config import (AppConfig,
                                                             get_config)
from generativeaiexamples_tpu_torch.utils.configuration import (
    asdict, from_dict, from_file, print_help, update_dict)
from generativeaiexamples_tpu_torch.utils.errors import (BreakerOpenError,
                                                         ChainError,
                                                         ConfigError,
                                                         EngineError,
                                                         RetrievalError,
                                                         SchedulerFullError)

from generativeaiexamples_tpu.utils import faults as jfaults
from generativeaiexamples_tpu.utils import resilience as jresilience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = ByteTokenizer()
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _clean_faults_and_breakers(tmp_path, monkeypatch):
    # The apps' retained telemetry writes its incidents here.
    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path))
    for f, r in ((faults, resilience), (jfaults, jresilience)):
        f.clear()
        r.reset_breakers()
    yield
    for f, r in ((faults, resilience), (jfaults, jresilience)):
        f.clear()
        r.reset_breakers()


def _run(coro):
    return asyncio.get_event_loop_policy().new_event_loop() \
        .run_until_complete(coro)


# ------------------------------------------------------------------ config

def test_config_defaults_match_the_reference_but_the_engine_names():
    from generativeaiexamples_tpu.utils import app_config as japp
    from generativeaiexamples_tpu.utils import configuration as jconf
    ours = asdict(from_dict(AppConfig, {}))
    theirs = jconf.asdict(jconf.from_dict(japp.AppConfig, {}))
    assert ours["llm"].pop("model_engine") == "torch-cuda"
    assert theirs["llm"].pop("model_engine") == "tpu-jax"
    assert ours["embeddings"].pop("model_engine") == "torch-cuda"
    assert theirs["embeddings"].pop("model_engine") == "tpu-jax"
    assert ours == theirs
    cfg = from_dict(AppConfig, {})
    assert (cfg.text_splitter.chunk_size, cfg.text_splitter.chunk_overlap,
            cfg.retriever.top_k, cfg.retriever.max_context_tokens,
            cfg.embeddings.dimensions, cfg.vector_store.name) == (
        510, 200, 4, 1500, 1024, "exact")
    assert "[INST]" in cfg.prompts.rag_template


@pytest.mark.parametrize("section,field,name,ours", [
    ("llm", "model_engine", "tpu-jax", "torch-cuda"),
    ("llm", "model_engine", "tpu-http", "openai-compat"),
    ("embeddings", "model_engine", "tpu-jax", "torch-cuda"),
    ("vector_store", "name", "exact-tpu", "exact-cuda")])
def test_reference_tpu_names_are_refused(section, field, name, ours):
    with pytest.raises(ConfigError, match=ours):
        from_dict(AppConfig, {section: {field: name}})


def test_file_overlay_yaml_and_env(tmp_path, monkeypatch):
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"vector_store": {"name": "ivf", "nlist": 128},
                             "llm": {"model_name": "from-file"}}))
    cfg = from_file(AppConfig, str(p))
    assert (cfg.vector_store.name, cfg.vector_store.nlist,
            cfg.vector_store.nprobe) == ("ivf", 128, 16)
    monkeypatch.setenv("APP_LLM_MODELNAME", "from-env")
    monkeypatch.setenv("APP_ENGINE_MAXBATCHSIZE", "32")
    monkeypatch.setenv("APP_TRACING_ENABLED", "true")
    cfg = from_file(AppConfig, str(p))
    assert cfg.llm.model_name == "from-env"
    assert cfg.engine.max_batch_size == 32 and cfg.tracing.enabled is True
    y = tmp_path / "config.yaml"
    y.write_text("llm:\n  model_engine: echo\nengine:\n  page_size: 64\n")
    pytest.importorskip("yaml")
    cfg = from_file(AppConfig, str(y))
    assert cfg.llm.model_engine == "echo" and cfg.engine.page_size == 64


def test_missing_file_roundtrip_help_and_merge(tmp_path, monkeypatch):
    assert from_file(AppConfig, str(tmp_path / "none.yaml")) \
        .llm.model_engine == "torch-cuda"
    cfg = from_dict(AppConfig, {})
    assert from_dict(AppConfig, asdict(cfg)) == cfg
    buf = io.StringIO()
    print_help(AppConfig, stream=buf)
    for section in ("vector_store", "llm", "text_splitter", "embeddings",
                    "prompts", "retriever", "mesh", "engine", "tracing",
                    "serving"):
        assert section in buf.getvalue()
    assert "APP_LLM_MODELNAME" in buf.getvalue()
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    assert update_dict(base, {"a": {"b": 9}, "e": 4}) == {
        "a": {"b": 9, "c": 2}, "d": 3, "e": 4}
    assert base["a"]["b"] == 1
    with pytest.raises((ConfigError, ValueError)):
        from_dict(AppConfig, {"engine": {"max_batch_size": "not-a-number"}})
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"llm": {"model_name": "singleton-test"}}))
    monkeypatch.setenv("APP_CONFIG_FILE", str(p))
    cfg = get_config(reload=True)
    assert cfg.llm.model_name == "singleton-test" and get_config() is cfg


# ------------------------------------------------- faults and breakers

@pytest.mark.parametrize("plan", [
    "retrieval.search=fail; embed=delay:0.01; engine.dispatch=fail:timeout*2",
    "router.forward[r0]=fail:conn, replica.heartbeat=hang*3"])
def test_fault_plans_parse_as_the_reference(plan):
    def fields(parsed):
        return {k: {**vars(v), "exc": v.exc.__name__}
                for k, v in parsed.items()}
    assert fields(faults.parse_plan(plan)) == fields(jfaults.parse_plan(plan))
    assert faults.POINTS == jfaults.POINTS


def test_fault_modes_and_refusals():
    faults.set_plan("retrieval.search=fail; embed=delay:0.01; "
                    "engine.dispatch=fail:timeout*2")
    with pytest.raises(faults.FaultInjected):
        faults.inject("retrieval.search")
    t0 = time.monotonic()
    faults.inject("embed")
    assert time.monotonic() - t0 >= 0.01
    for _ in range(2):
        with pytest.raises(TimeoutError):
            faults.inject("engine.dispatch")
    faults.inject("engine.dispatch")
    assert faults.fired("engine.dispatch") == 2
    for bad in ("retrieval.serch=fail", "embed=explode"):
        with pytest.raises(faults.FaultPlanError):
            faults.set_plan(bad)


def test_breaker_cycle_and_metrics():
    clock = [0.0]
    br = resilience.CircuitBreaker("t", failure_threshold=2, cooldown_s=5.0,
                                   clock=lambda: clock[0])
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and br.trips == 1 and not br.allow()
    assert br.retry_after_s() == pytest.approx(5.0)
    snap = obs_metrics.REGISTRY.snapshot()
    assert snap['breaker_state{name="t"}'] == 2
    clock[0] = 5.1
    assert br.state == "half_open" and br.allow() and not br.allow()
    br.release_probe()
    assert br.state == "half_open" and br.allow()
    br.record_success()
    assert br.state == "closed"
    dep = resilience.CircuitBreaker("dep", failure_threshold=1,
                                    cooldown_s=60.0)
    with pytest.raises(ValueError):
        dep.call(lambda: (_ for _ in ()).throw(ValueError("x")))
    with pytest.raises(BreakerOpenError) as ei:
        dep.call(lambda: "never runs")
    assert ei.value.breaker == "dep" and ei.value.retry_after_s > 0
    delays = []
    with pytest.raises(ConnectionError):
        resilience.retry_call(
            lambda: (_ for _ in ()).throw(ConnectionError("x")), attempts=4,
            base_delay=0.1, max_delay=10.0, rng=lambda: 1.0,
            sleep=delays.append)
    assert delays == [0.1, 0.2, 0.4]


def test_similarity_search_wraps_failures_and_opens_its_breaker():
    idx = DocumentIndex(HashEmbedder(dim=32))
    idx.add_texts(["the MXU is a systolic array"])
    for point, reason in (("retrieval.search", "retrieval"),
                          ("embed", "embed")):
        faults.set_plan(f"{point}=fail")
        with pytest.raises(RetrievalError) as ei:
            idx.similarity_search("mxu", k=1)
        assert ei.value.reason == reason
    resilience.reset_breakers()
    faults.set_plan("retrieval.search=fail")
    br = resilience.get_breaker("retrieval", failure_threshold=3,
                                cooldown_s=60.0)
    for _ in range(3):
        with pytest.raises(RetrievalError):
            idx.similarity_search("mxu", k=1)
    assert br.state == "open"
    fired = faults.fired("retrieval.search")
    with pytest.raises(BreakerOpenError):
        idx.similarity_search("mxu", k=1)
    assert faults.fired("retrieval.search") == fired


# ------------------------------------------------ splitter, readers, llm

def test_splitter_and_cap_context_match_the_reference(repo_root):
    from generativeaiexamples_tpu.chains import splitter as jsplit
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JByte
    texts = [". ".join(f"Sentence number {i} about TPUs" for i in range(100)),
             "x" * 400, "short text", "   ",
             (repo_root / "docs" / "chain-server.md").read_text()]
    for size, overlap in ((120, 30), (50, 10), (510, 200)):
        ours = TokenTextSplitter(TOK, chunk_size=size, chunk_overlap=overlap)
        ref = jsplit.TokenTextSplitter(JByte(), chunk_size=size,
                                       chunk_overlap=overlap)
        for text in texts:
            assert ours.split_text(text) == ref.split_text(text)
        assert all(len(TOK.encode(c, add_bos=False)) <= size
                   for c in ours.split_text(texts[0]))
    assert ours.split_text("short text") == ["short text"]
    with pytest.raises(ValueError):
        TokenTextSplitter(TOK, chunk_size=10, chunk_overlap=10)
    docs = ["a" * 100, "b" * 100, "c" * 100]
    assert cap_context(docs, 250, TOK) == jsplit.cap_context(docs, 250,
                                                              JByte()) \
        == docs[:2]


def _make_minimal_pdf(path, text):
    stream = f"BT /F1 12 Tf 72 720 Td ({text}) Tj ET".encode()
    compressed = zlib.compress(stream)
    body = (b"%PDF-1.4\n1 0 obj<</Length " + str(len(compressed)).encode()
            + b"/Filter/FlateDecode>>stream\n" + compressed
            + b"\nendstream endobj\ntrailer<<>>\n%%EOF")
    path.write_bytes(body)


def test_readers(tmp_path):
    p = tmp_path / "doc.md"
    p.write_text("hello world")
    assert read_document(str(p)) == "hello world"
    pdf = tmp_path / "doc.pdf"
    _make_minimal_pdf(pdf, "TPU systolic arrays rock")
    assert "TPU systolic arrays rock" in read_pdf(str(pdf))
    q = tmp_path / "doc.xyz"
    q.write_bytes(b"x")
    with pytest.raises(ChainError, match="unsupported"):
        read_document(str(q))
    # .pptx and .docx go to the assistant's zip parsers, as the
    # reference's do: a file that is not a zip archive fails there.
    from generativeaiexamples_tpu.chains.readers import \
        read_document as jread
    for ext in ("pptx", "docx"):
        q = tmp_path / f"doc.{ext}"
        q.write_bytes(b"x")
        for reader in (read_document, jread):
            with pytest.raises(zipfile.BadZipFile):
                reader(str(q))
    pytest.importorskip("bs4")
    h = tmp_path / "doc.html"
    h.write_text("<html><body><script>x()</script><p>Visible text</p>"
                 "</body></html>")
    assert "Visible text" in read_document(str(h))
    assert "x()" not in read_document(str(h))


def test_echo_llm_and_factory():
    from generativeaiexamples_tpu.chains.llm import EchoLLM as JEcho
    llm = EchoLLM(prefix="", tail_chars=50)
    assert llm.complete("hello world", max_tokens=64) == "hello world"
    for prompt, stop in (("abc STOP def", ["STOP"]),
                         ("<s>[INST] q [/INST]" * 5, None)):
        assert list(llm.stream(prompt, 64, stop)) == list(
            JEcho(prefix="", tail_chars=50).stream(prompt, 64, stop))
    assert isinstance(get_llm(from_dict(AppConfig, {
        "llm": {"model_engine": "echo"}})), EchoLLM)
    assert isinstance(get_llm(from_dict(AppConfig, {
        "llm": {"model_engine": "openai-compat",
                "server_url": "http://x:1"}})), OpenAICompatLLM)
    with pytest.raises(ConfigError, match="Engine"):
        get_llm(from_dict(AppConfig, {}))
    for name in ("tpu-jax", "nope"):
        with pytest.raises(ConfigError):
            get_llm(from_dict(AppConfig, {"llm": {"model_engine": name}}))
    with pytest.raises(ConfigError):
        OpenAICompatLLM("")


def test_openai_compat_llm_streams_deltas():
    """The urllib client reads a /v1/completions SSE stream as deltas,
    sends greedy as temperature 0, and raises on an HTTP error."""
    seen = []

    async def completions(request):
        body = await request.json()
        seen.append(body)
        if body["prompt"] == "fail":
            return web.json_response({"error": "x"}, status=503)
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        for piece in ("Hel", "", "lo"):
            await resp.write(("data: " + json.dumps(
                {"choices": [{"text": piece}]}) + "\n\n").encode())
        await resp.write(b"data: [DONE]\n\n")
        return resp

    app = web.Application()
    app.router.add_post("/v1/completions", completions)
    with _serve(app) as base:
        llm = OpenAICompatLLM(base, model_name="m")
        assert list(llm.stream("hi", max_tokens=5, stop=["x"])) == ["Hel",
                                                                   "lo"]
        assert list(llm.stream("hi", top_k=4, temperature=0.7)) == [
            "Hel", "lo"]
        with pytest.raises(urllib.error.HTTPError):
            list(llm.stream("fail"))
    assert seen[0]["temperature"] == 0.0 and seen[0]["stop"] == ["x"]
    assert seen[0]["stream"] is True and seen[0]["model"] == "m"
    assert seen[1]["top_k"] == 4 and seen[1]["temperature"] == 0.7


# ---------------------------------------------------------------- example

def _echo_config():
    return {"llm": {"model_engine": "echo"},
            "embeddings": {"model_engine": "hash", "dimensions": 64},
            "text_splitter": {"chunk_size": 100, "chunk_overlap": 20}}


def _make_example():
    return QAChatbot(llm=EchoLLM(prefix="", tail_chars=4000),
                     embedder=HashEmbedder(dim=64),
                     config=from_dict(AppConfig, _echo_config()))


def test_developer_rag_matches_the_reference(tmp_path):
    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EchoLLM as JEcho
    from generativeaiexamples_tpu.embed.encoder import HashEmbedder as JHash
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    ours = _make_example()
    ref = JBot(llm=JEcho(prefix="", tail_chars=4000), embedder=JHash(dim=64),
               config=jfrom_dict(JAppConfig, _echo_config()),
               fused_rag=False)
    doc = tmp_path / "kb.txt"
    doc.write_text("The MXU is a 128x128 systolic array. TPUs communicate "
                   "over ICI links. Paris is the capital of France. " * 4)
    for bot in (ours, ref):
        bot.ingest_docs(str(doc), "kb.txt")
    assert len(ours.index) == len(ref.index) >= 2
    for args in (("What is the MXU?", 4000), ("Paris?", 64)):
        assert "".join(ours.rag_chain(*args)) == "".join(ref.rag_chain(*args))
        assert "".join(ours.llm_chain("ctx", *args)) == "".join(
            ref.llm_chain("ctx", *args))
    assert "systolic" in "".join(ours.rag_chain("What is the MXU?", 4000))
    hits = ours.document_search("systolic array", 2)
    assert hits == ref.document_search("systolic array", 2)
    assert hits[0]["source"] == "kb.txt"
    assert ours.index.get(0).metadata["source_b64"] == "a2IudHh0"
    # An empty index passed in brings its embedder and store (it is
    # falsy: it has a length).
    index = DocumentIndex(HashEmbedder(dim=64),
                          store=ExactStore(dim=64, backend="numpy"))
    bot = QAChatbot(llm=EchoLLM(), index=index,
                    config=from_dict(AppConfig, _echo_config()))
    assert bot.index is index and bot.index.store.backend == "numpy"
    # fused_rag=True asks for fused RAG; without an in-process engine the
    # chatbot keeps the host path after ingest, as the reference's does.
    asked = QAChatbot(llm=EchoLLM(), embedder=HashEmbedder(dim=64),
                      config=from_dict(AppConfig, _echo_config()),
                      fused_rag=True)
    asked.ingest_docs(str(doc), "kb.txt")
    assert not asked._fused_ready and asked.last_sources == []


def test_degrade_to_llm_notice_and_llm_down():
    """Retrieval down: the notice, then the model's answer, counted once
    in ``degraded_total``; retrieval AND the LLM down: the typed error
    before anything is emitted, and no count."""
    ex = _make_example()
    ex.index.add_texts(["some doc"])
    faults.set_plan("retrieval.search=fail")
    key = 'degraded_total{reason="retrieval"}'
    before = obs_metrics.REGISTRY.snapshot().get(key, 0.0)
    out = "".join(ex.rag_chain("q?", 4000))
    assert out.startswith(DEGRADED_NOTICE) and out.rstrip().endswith("q?")
    assert obs_metrics.REGISTRY.snapshot()[key] == before + 1

    class DeadLLM(EchoLLM):
        def stream(self, *a, **kw):
            raise EngineError("engine is dead")
            yield  # pragma: no cover

    ex.llm = DeadLLM()
    gen = ex.rag_chain("q", 8)
    with pytest.raises(EngineError):
        next(gen)
    assert obs_metrics.REGISTRY.snapshot()[key] == before + 1


def test_discover_example():
    assert discover_example("developer_rag") is QAChatbot
    with pytest.raises(ChainError):
        discover_example("generativeaiexamples_tpu_torch.chains.base")


# ----------------------------------------------------------------- server

async def _with_client(example, fn):
    with tempfile.TemporaryDirectory() as upload_dir:
        app = create_app(example, upload_dir=upload_dir)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client, app)
        finally:
            await client.close()


def test_server_health_metrics_upload_generate_search():
    async def fn(client, app):
        resp = await client.get("/health")
        assert resp.status == 200 and (await resp.json())["status"] == "ok"
        assert (await client.get("/metrics")).status == 200
        form = aiohttp.FormData()
        form.add_field("file",
                       b"TPU pods scale with ICI. The MXU does matmuls.",
                       filename="notes.txt")
        resp = await client.post("/uploadDocument", data=form)
        assert resp.status == 200, await resp.text()
        assert await resp.json() == {"filename": "notes.txt",
                                     "status": "ingested"}
        resp = await client.post("/generate", json={
            "question": "What does the MXU do?",
            "use_knowledge_base": True, "num_tokens": 4000})
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        assert resp.headers["X-Request-ID"]
        assert "MXU" in (await resp.read()).decode()
        resp = await client.post("/generate", json={
            "question": "2+2?", "use_knowledge_base": False,
            "num_tokens": 4000})
        assert "2+2?" in (await resp.read()).decode()
        resp = await client.post("/documentSearch", json={
            "content": "matmul unit", "num_docs": 2})
        hits = await resp.json()
        assert hits and hits[0]["source"] == "notes.txt"
        assert set(hits[0]) == {"score", "source", "content"}
        assert (await client.post("/generate", json={})).status == 422
        text = await (await client.get("/metrics")).text()
        assert "documents_ingested_total" in text
        assert "chain_generate" in text
    _run(_with_client(_make_example(), fn))


class _Broken(BaseExample):
    def __init__(self, exc=None, mid=False):
        self.exc, self.mid = exc, mid

    def llm_chain(self, context, question, num_tokens):
        if self.mid:
            yield "partial "
            yield "answer"
        raise self.exc

    def rag_chain(self, prompt, num_tokens):
        yield from self.llm_chain("", prompt, num_tokens)

    def ingest_docs(self, data_dir, filename):
        raise RuntimeError("boom")


@pytest.mark.parametrize("exc,status,err_type", [
    (RuntimeError("boom"), 500, "internal_error"),
    (ChainError("bad chain"), 500, "chain_error"),
    (SchedulerFullError("request queue full (4)"), 429, "queue_full"),
    (EngineError("engine is dead"), 503, "engine_error"),
    (BreakerOpenError("open", breaker="x", retry_after_s=3.0), 503,
     "dependency_unavailable")])
def test_pre_stream_failures_are_real_statuses(exc, status, err_type):
    async def fn(client, app):
        resp = await client.post("/generate", json={"question": "x",
                                                    "num_tokens": 10})
        assert resp.status == status
        body = await resp.json()
        assert body["error"]["type"] == err_type
        assert str(exc) in body["error"]["message"]
        assert body["request_id"] == resp.headers["X-Request-ID"]
        if status == 429 or err_type == "dependency_unavailable":
            assert int(resp.headers["Retry-After"]) >= 1
        form = aiohttp.FormData()
        form.add_field("file", b"x", filename="a.txt")
        resp = await client.post("/uploadDocument", data=form)
        assert resp.status == 500
        assert (await resp.json())["error"]["type"] == "ingest_error"
    _run(_with_client(_Broken(exc), fn))


def test_mid_stream_error_degrades_with_event():
    async def fn(client, app):
        resp = await client.post("/generate", json={"question": "x",
                                                    "num_tokens": 10})
        assert resp.status == 200
        body = (await resp.read()).decode()
        assert body.startswith("partial answer")
        assert "[error] mid boom" in body
        event = body.split("event: error\ndata:", 1)[1].strip()
        payload = json.loads(event.split("\n", 1)[0])
        assert payload["message"] == "mid boom"
        assert payload["request_id"] == resp.headers["X-Request-ID"]
    _run(_with_client(_Broken(RuntimeError("mid boom"), mid=True), fn))


def test_generate_breaker_fast_503_and_half_open_recovery():
    class Flaky(BaseExample):
        down = True

        def llm_chain(self, context, question, num_tokens):
            if self.down:
                raise EngineError("engine is dead")
            yield "recovered"

        def rag_chain(self, prompt, num_tokens):
            yield from self.llm_chain("", prompt, num_tokens)

        def ingest_docs(self, data_dir, filename):
            pass

    ex = Flaky()

    async def fn(client, app):
        breaker = app[GENERATE_BREAKER]
        breaker.failure_threshold = 2
        breaker.cooldown_s = 0.05
        for _ in range(2):
            resp = await client.post("/generate", json={"question": "x"})
            assert resp.status == 503
        assert breaker.state == "open"
        resp = await client.post("/generate", json={"question": "x"})
        assert resp.status == 503
        assert (await resp.json())["error"]["type"] == "engine_unavailable"
        assert "Retry-After" in resp.headers
        assert (await client.get("/health")).status == 503
        ex.down = False
        await asyncio.sleep(0.06)
        resp = await client.post("/generate", json={"question": "x"})
        assert resp.status == 200
        assert (await resp.read()).decode() == "recovered"
        assert breaker.state == "closed"
    _run(_with_client(ex, fn))


def test_document_search_timeout_504(monkeypatch):
    ex = _make_example()
    orig = ex.document_search

    def slow(content, num_docs):
        time.sleep(1.0)
        return orig(content, num_docs)

    ex.document_search = slow
    monkeypatch.setenv("CHAIN_EXECUTOR_TIMEOUT_S", "0.05")

    async def fn(client, app):
        resp = await client.post("/documentSearch", json={"content": "x"})
        assert resp.status == 504
        assert (await resp.json())["error"]["type"] == "timeout"
    _run(_with_client(ex, fn))


def test_generate_deadline_header_sheds_when_hopeless(monkeypatch):
    """With recent queue waits far above the caller's deadline the edge
    answers 429 + Retry-After from the estimate; without a deadline the
    request streams."""
    recorder = obs_flight.FlightRecorder(completed_cap=64)
    monkeypatch.setattr(obs_flight, "RECORDER", recorder)
    for i in range(32):
        tl = recorder.begin(f"seed-{i}", fresh=True)
        tl.stage("engine_admit_pickup", 5.0)
        recorder.complete(tl)

    async def fn(client, app):
        resp = await client.post(
            "/generate", json={"question": "x", "num_tokens": 8},
            headers={"X-Deadline-Ms": "100"})
        assert resp.status == 429
        assert (await resp.json())["error"]["type"] == "deadline_unmeetable"
        assert int(resp.headers["Retry-After"]) >= 5
        resp = await client.post("/generate", json={
            "question": "hello", "num_tokens": 64,
            "use_knowledge_base": False})
        assert resp.status == 200
    _run(_with_client(_make_example(), fn))


def test_drain_transitions_and_unported_routes():
    async def fn(client, app):
        body = await (await client.get("/health")).json()
        assert body["status"] == "ok" and body["draining"] is False
        assert body["load"] == {"in_flight": 0}
        assert (await client.post("/control/drain")).status == 200
        resp = await client.get("/health")
        assert resp.status == 503
        assert (await resp.json())["status"] == "draining"
        for path, payload in (("/generate", {"question": "q"}),
                              ("/documentSearch", {"content": "c"})):
            resp = await client.post(path, json=payload)
            assert resp.status == 429
            assert (await resp.json())["error"]["type"] == "draining"
            assert "Retry-After" in resp.headers
        form = aiohttp.FormData()
        form.add_field("file", b"x", filename="a.txt")
        assert (await client.post("/uploadDocument",
                                  data=form)).status == 429
        assert (await client.post("/control/undrain")).status == 200
        assert (await client.get("/health")).status == 200
        resp = await client.post("/generate", json={"question": "hi"})
        assert resp.status == 200
        # The KV-tier routes (the fleet's page export and prefill leg
        # too) and a resume need an engine; this chain has none.
        for method, path in (("GET", "/control/kv_pages?hashes=ab"),
                             ("POST", "/control/prefill"),
                             ("POST", "/control/kv_suspend"),
                             ("POST", "/control/kv_resume")):
            resp = await client.request(method, path, json={"text": "t"})
            assert resp.status == 404, path
            assert (await resp.json())["error"]["type"] == "no_engine"
        resp = await client.post("/generate", json={
            "question": "q", "use_knowledge_base": False,
            "resume": {"text": "abc", "attempt": 1}})
        assert resp.status == 409
        body = await resp.json()
        assert body["error"]["type"] == "resume_unsupported"
        assert "no engine" in body["error"]["message"]
        for path in ("/debug/requests", "/debug/rounds", "/debug/history",
                     "/debug/alerts", "/debug/incidents"):
            assert (await client.get(path)).status == 200, path
    _run(_with_client(_make_example(), fn))


def test_drain_counts_in_flight_streams():
    release = threading.Event()

    class Slow(BaseExample):
        def llm_chain(self, context, question, num_tokens):
            yield "first"
            release.wait(timeout=30)
            yield "second"

        def rag_chain(self, prompt, num_tokens):
            yield from self.llm_chain("", prompt, num_tokens)

        def ingest_docs(self, data_dir, filename):
            pass

    async def fn(client, app):
        resp = await client.post("/generate", json={
            "question": "q", "use_knowledge_base": False})
        assert resp.status == 200
        body = await (await client.post("/control/drain")).json()
        assert body["in_flight"] == 1
        assert (await client.post("/generate",
                                  json={"question": "x"})).status == 429
        release.set()
        assert (await resp.read()).decode().endswith("second")
        deadline = time.monotonic() + 10
        while app[DRAIN_STATE].in_flight and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        assert app[DRAIN_STATE].in_flight == 0
    _run(_with_client(Slow(), fn))


# ------------------------------------------- the slice as a whole (golden)

GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_tiny")
DOCS = ("frontend.md", "evaluation.md", "README.md")
ENGINE_KW = dict(max_slots=2, max_input_length=448, max_output_length=64,
                 prefill_buckets=(64, 128, 256, 448), page_size=16,
                 dtype="float32", kv_pool_tokens=None, max_queue=4)
# Cut so that a RAG prompt fits golden-tiny's 512 positions.
CHAIN_CFG = {"text_splitter": {"chunk_size": 200, "chunk_overlap": 50},
             "retriever": {"top_k": 3, "max_context_tokens": 600}}
QUESTION = "How does the chatbot evaluate its answers?"


@contextlib.contextmanager
def _serve(app):
    """Run ``app`` on a free local port in a thread; its cleanup runs on
    exit."""
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


def _call(url, body=None, headers=None, data=None):
    """(status, headers, text) of a GET, a JSON POST or a raw POST."""
    if body is not None:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read().decode()


def _upload(base, path):
    boundary = uuid.uuid4().hex
    name = os.path.basename(path)
    with open(path, "rb") as f:
        payload = f.read()
    data = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"{name}\"\r\nContent-Type: text/markdown\r\n\r\n"
            ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return _call(base + "/uploadDocument", data=data, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})


@pytest.fixture(scope="module")
def rag_servers(tmp_path_factory):
    """The port's chain server over the port's engine and the reference's
    over the JAX ``Engine``, both on golden-tiny with the same seeded
    encoder-tiny weights and an exact store; the three docs uploaded to
    each."""
    import jax
    import jax.numpy as jnp
    import torch

    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JEngineLLM
    from generativeaiexamples_tpu.chains.server import create_app as jcreate
    from generativeaiexamples_tpu.embed.encoder import \
        EmbeddingService as JEmbed
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models import encoder as jenc
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu.models.tokenizer import ByteTokenizer as JB
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    from generativeaiexamples_tpu.retrieval.docstore import \
        DocumentIndex as JIndex
    from generativeaiexamples_tpu.retrieval.exact import \
        ExactStore as JExact
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import (ENCODER_TINY,
                                                               GOLDEN_TINY)
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer

    jparams = jenc.init_params(JENC, jax.random.key(0))
    params = enc.encoder_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           ENCODER_TINY)
    eng = Engine(load_checkpoint(GOLDEN, GOLDEN_TINY, dtype=torch.float32,
                                 device="cpu"),
                 GOLDEN_TINY, get_tokenizer(GOLDEN),
                 EngineConfig(**ENGINE_KW), device="cpu")
    jeng = JEngine(jload(GOLDEN, JCFG, dtype=jnp.float32), JCFG,
                   jget(GOLDEN), JConfig(**ENGINE_KW))
    ours = QAChatbot(
        llm=EngineLLM(eng),
        index=DocumentIndex(EmbeddingService(params, ENCODER_TINY, TOK),
                            store=ExactStore(dim=64)),
        config=from_dict(AppConfig, CHAIN_CFG), fused_rag=False)
    # The embedder is passed as well: the reference takes an empty index
    # for no index and would build its default encoder.
    jembed = JEmbed(jparams, JENC, JB())
    ref = JBot(llm=JEngineLLM(jeng), embedder=jembed,
               index=JIndex(jembed, store=JExact(dim=64)),
               config=jfrom_dict(JAppConfig, CHAIN_CFG), fused_rag=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("port_run")))
        app = create_app(ours, str(tmp_path_factory.mktemp("port_uploads")))
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("ref_run")))
        japp = jcreate(ref, str(tmp_path_factory.mktemp("ref_uploads")))
    with _serve(app) as port, _serve(japp) as jref:
        sides = {"port": port, "ref": jref}
        for name in DOCS:
            for side, base in sides.items():
                status, _, text = _upload(base, os.path.join(ROOT, "docs",
                                                             name))
                assert status == 200, (side, text)
        assert len(ours.index) == len(ref.index) > 3 * len(DOCS)
        yield {**sides, "bots": {"port": ours, "ref": ref},
               "engines": {"port": eng, "ref": jeng}}
    eng.stop()
    jeng.stop()


def _both(servers, path, body, headers=None):
    return {side: _call(servers[side] + path, body, headers)
            for side in ("port", "ref")}


def test_rag_document_search_matches_the_reference(rag_servers):
    for content, n in ((QUESTION, 3), ("deployment on kubernetes", 5)):
        out = _both(rag_servers, "/documentSearch",
                    {"content": content, "num_docs": n})
        assert out["port"][0] == out["ref"][0] == 200
        ours, ref = (json.loads(out[s][2]) for s in ("port", "ref"))
        assert len(ours) == n
        assert [(h["source"], h["content"]) for h in ours] == [
            (h["source"], h["content"]) for h in ref]
        np.testing.assert_allclose([h["score"] for h in ours],
                                   [h["score"] for h in ref], atol=1e-5)
        assert {h["source"] for h in ours} <= set(DOCS)


@pytest.mark.parametrize("use_kb", [True, False], ids=["kb", "no_kb"])
def test_rag_generate_streams_the_reference_text(rag_servers, use_kb):
    body = {"question": QUESTION, "use_knowledge_base": use_kb,
            "num_tokens": 24}
    out = _both(rag_servers, "/generate", body)
    assert out["port"][0] == out["ref"][0] == 200
    assert out["port"][2] == out["ref"][2]
    assert len(out["port"][2]) > 10 and "[notice]" not in out["port"][2]
    # The streamed text is the engine's greedy text for the prompt the
    # chain assembled.
    bot = rag_servers["bots"]["port"]
    if use_kb:
        docs = bot.index.similarity_search(QUESTION,
                                           k=bot.config.retriever.top_k)
        prompt = bot.rag_prompt(docs, QUESTION)
    else:
        prompt = bot.config.prompts.chat_template.format(
            context_str="", query_str=QUESTION)
    assert bot.llm.complete(prompt, max_tokens=24,
                            stop=["</s>", "[INST]"]) == out["port"][2]


def test_rag_generate_timeline_has_the_chain_stages(rag_servers):
    """The chain server's request timeline is the engine stream's (adopted
    through the context), and holds the chain's stages beside the
    engine's, as the reference's does."""
    stages = {}
    for side in ("port", "ref"):
        rid = f"rag-stages-{side}"
        status, headers, _ = _call(
            rag_servers[side] + "/generate",
            {"question": QUESTION, "num_tokens": 4},
            {"X-Request-ID": rid})
        assert status == 200 and headers["X-Request-ID"] == rid
        _, _, text = _call(rag_servers[side] + "/debug/requests?limit=20")
        tl = next(t for t in json.loads(text)["completed"]
                  if t["request_id"] == rid)
        stages[side] = {e["event"] for e in tl["events"] if "dur_ms" in e}
        assert tl["meta"]["route"] == "/generate"
        assert tl["meta"]["finish"] in ("length", "eos", "stop")
    chain = {"embedding", "embed_dispatch", "embed_readback", "retrieve",
             "templating", "llm_first_chunk", "engine_ttft", "llm",
             "engine_admit_pickup"}
    assert chain <= stages["port"] and chain <= stages["ref"]


def test_rag_degraded_answer_matches_the_reference(rag_servers):
    key = 'degraded_total{reason="retrieval"}'
    from generativeaiexamples_tpu.obs import metrics as jmetrics
    before = {"port": obs_metrics.REGISTRY.snapshot().get(key, 0.0),
              "ref": jmetrics.REGISTRY.snapshot().get(key, 0.0)}
    faults.set_plan("retrieval.search=fail")
    jfaults.set_plan("retrieval.search=fail")
    out = _both(rag_servers, "/generate", {"question": QUESTION,
                                           "num_tokens": 16})
    assert out["port"][0] == out["ref"][0] == 200
    assert out["port"][2] == out["ref"][2]
    assert out["port"][2].startswith(DEGRADED_NOTICE)
    assert len(out["port"][2]) > len(DEGRADED_NOTICE)
    assert obs_metrics.REGISTRY.snapshot()[key] == before["port"] + 1
    assert jmetrics.REGISTRY.snapshot()[key] == before["ref"] + 1
    status, _, text = _call(rag_servers["port"] + "/documentSearch",
                            {"content": QUESTION})
    assert status == 500
    assert json.loads(text)["error"]["type"] == "search_error"


def test_rag_deadline_expired_before_output_is_504(rag_servers,
                                                   monkeypatch):
    """A deadline armed on the chain's timeline reaches the engine through
    the context: expired before any output, both servers answer 504."""
    from generativeaiexamples_tpu.obs import flight as jflight
    monkeypatch.setattr(obs_flight, "RECORDER", obs_flight.FlightRecorder())
    monkeypatch.setattr(jflight, "RECORDER", jflight.FlightRecorder())
    out = _both(rag_servers, "/generate",
                {"question": QUESTION, "use_knowledge_base": False,
                 "num_tokens": 8}, {"X-Deadline-Ms": "0.001"})
    for side, (status, _, text) in out.items():
        assert status == 504, (side, text)
        assert json.loads(text)["error"]["type"] == "deadline_exceeded"
    assert rag_servers["engines"]["port"].stats["deadline_queue_drops"] >= 1


# ------------------------------------------- KV tier routes and resume

@pytest.fixture(scope="module")
def tier_servers(tmp_path_factory):
    """The port's chain server over the port's engine and the reference's
    over the JAX engine, golden-tiny with the host KV tier on, no
    retrieval (``use_knowledge_base`` false)."""
    import jax.numpy as jnp
    import torch

    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JEngineLLM
    from generativeaiexamples_tpu.chains.server import create_app as jcreate
    from generativeaiexamples_tpu.embed.encoder import \
        HashEmbedder as JHash
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer

    kw = {**ENGINE_KW, "kv_host_pool_tokens": 4096,
          "sched_round_budget_tokens": 448}
    eng = Engine(load_checkpoint(GOLDEN, GOLDEN_TINY, dtype=torch.float32,
                                 device="cpu"),
                 GOLDEN_TINY, get_tokenizer(GOLDEN), EngineConfig(**kw),
                 device="cpu")
    jeng = JEngine(jload(GOLDEN, JCFG, dtype=jnp.float32), JCFG,
                   jget(GOLDEN), JConfig(**kw))
    cfg = {"embeddings": {"model_engine": "hash", "dimensions": 64}}
    ours = QAChatbot(llm=EngineLLM(eng), embedder=HashEmbedder(dim=64),
                     config=from_dict(AppConfig, cfg), fused_rag=False)
    ref = JBot(llm=JEngineLLM(jeng), embedder=JHash(dim=64),
               config=jfrom_dict(JAppConfig, cfg), fused_rag=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("tier_run")))
        app = create_app(ours, str(tmp_path_factory.mktemp("tier_up")))
        japp = jcreate(ref, str(tmp_path_factory.mktemp("tier_jup")))
    with _serve(app) as port, _serve(japp) as jref:
        yield {"port": port, "ref": jref, "engines": {"port": eng,
                                                       "ref": jeng},
               "prompt": ours.config.prompts.chat_template.format(
                   context_str="", query_str=QUESTION)}
    eng.stop()
    jeng.stop()


def _raw(url, body=None, blob=None):
    """(status, body bytes) of a JSON POST or a raw octet-stream POST."""
    if body is not None:
        data, kind = json.dumps(body).encode(), "application/json"
    else:
        data, kind = blob, "application/octet-stream"
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": kind})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_kv_session_routes_answer_as_the_references(tier_servers):
    """Suspend a conversation on each server after a turn, resume each
    blob on the other server: the same statuses and block counts, and the
    refusals (nothing cached, no text, a malformed blob) match. The
    resumed blocks then serve the next turn from the host tier."""
    gen = {"question": QUESTION, "use_knowledge_base": False,
           "num_tokens": 8}
    out = _both(tier_servers, "/generate", gen)
    assert out["port"][0] == out["ref"][0] == 200
    assert out["port"][2] == out["ref"][2]
    body = {"text": tier_servers["prompt"]}
    blobs = {}
    for side in ("port", "ref"):
        url = tier_servers[side] + "/control/kv_suspend"
        status, blobs[side] = _raw(url, body)
        assert status == 200, side
        # Suspended: nothing of the chain is cached any more.
        status, text = _raw(url, body)
        assert status == 404, side
        assert json.loads(text)["error"]["type"] == "not_cached"
        assert _raw(url, {})[0] == 422
    counts = {}
    for side, other in (("port", "ref"), ("ref", "port")):
        status, text = _raw(tier_servers[side] + "/control/kv_resume",
                            blob=blobs[other])
        assert status == 200, (side, text)
        counts[side] = json.loads(text)["blocks"]
        status, text = _raw(tier_servers[side] + "/control/kv_resume",
                            blob=b"junk")
        assert status == 422
        assert json.loads(text)["error"]["type"] == "bad_blob"
    assert counts["port"] == counts["ref"] > 0
    before = tier_servers["engines"]["port"].stats["kv_tier_restore_pages"]
    again = _both(tier_servers, "/generate", gen)
    assert again["port"][2] == again["ref"][2] == out["port"][2]
    assert tier_servers["engines"]["port"].stats[
        "kv_tier_restore_pages"] > before


def test_midstream_resume_continues_the_unbroken_stream(tier_servers):
    """A ``/generate`` resumed with the text already streamed answers
    ``X-Resume-Replayed`` and streams exactly the rest of the unbroken
    answer, on both servers. Exact only where the streamed head
    tokenizes back to the ids that produced it (sentencepiece may split
    a head differently), so the question is the first of a few whose
    answer's head does."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    eng = tier_servers["engines"]["port"]
    tok = eng.tokenizer
    eng.start()
    for question in (QUESTION, "Describe the engine.",
                     "What is paged KV caching?"):
        prompt = tier_servers["prompt"].replace(QUESTION, question)
        run = eng.submit(tok.encode(prompt), SamplingParams(
            max_tokens=24, top_k=1, stop_words=["</s>", "[INST]"]))
        text, ids = run.text(), run.token_ids
        cut = next((k for k in range(min(len(ids) - 1, 12), 0, -1)
                    if tok.encode(tok.decode(ids[:k]),
                                  add_bos=False) == ids[:k]
                    and text.startswith(tok.decode(ids[:k]))), None)
        if cut is not None:
            break
    assert cut is not None, "no question's answer head round-trips"
    gen = {"question": question, "use_knowledge_base": False,
           "num_tokens": 24}
    full = _both(tier_servers, "/generate", gen)
    assert full["port"][2] == full["ref"][2] == text
    head = tok.decode(ids[:cut])
    out = _both(tier_servers, "/generate",
                {**gen, "resume": {"text": head, "attempt": 1}})
    for side, (status, headers, body) in out.items():
        assert status == 200, (side, body)
        assert headers["X-Resume-Replayed"] == str(cut), side
        assert head + body == text, side
    status, _, body = _call(tier_servers["port"] + "/generate", {
        **gen, "num_tokens": cut, "resume": {"text": head}})
    assert status == 409
    assert json.loads(body)["error"]["type"] == "resume_exhausted"


def test_watchdog_flips_health_under_a_hung_dispatch(monkeypatch):
    """ENGINE_WATCHDOG_STALL_S with ``engine.dispatch=hang``: work waits
    and nothing moves, so ``/health`` answers 503 ``engine_stalled`` and
    the stall is counted; once the hang clears the requests finish and
    ``/health`` is 200 again."""
    import torch

    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
    monkeypatch.setenv("ENGINE_WATCHDOG_STALL_S", "0.2")
    monkeypatch.setenv("FAULT_HANG_MAX_S", "60")
    eng = Engine(load_checkpoint(GOLDEN, GOLDEN_TINY, dtype=torch.float32,
                                 device="cpu"),
                 GOLDEN_TINY, get_tokenizer(GOLDEN), EngineConfig(**ENGINE_KW),
                 device="cpu")
    example = QAChatbot(llm=EngineLLM(eng), embedder=HashEmbedder(dim=64),
                        config=from_dict(AppConfig, _echo_config()),
                        fused_rag=False)

    def health(base):
        status, _, text = _call(base + "/health")
        return status, json.loads(text)["status"]

    with _serve(create_app(example, tempfile.mkdtemp())) as base:
        eng.start()
        assert health(base) == (200, "ok")
        faults.set_plan("engine.dispatch=hang")
        sp = SamplingParams(max_tokens=6, top_k=1, ignore_eos=True)
        try:
            streams = [eng.submit(eng.tokenizer.encode("Paged KV"), sp),
                       eng.submit(eng.tokenizer.encode("caching"), sp)]
            deadline = time.monotonic() + TIMEOUT
            while health(base) != (503, "engine_stalled"):
                assert time.monotonic() < deadline, "never declared stalled"
                time.sleep(0.05)
            assert eng.stats["watchdog_stalls"] >= 1
        finally:
            faults.clear()
        for s in streams:
            s.text()
            assert s.finish_reason == "length"
        deadline = time.monotonic() + TIMEOUT
        while health(base) != (200, "ok"):
            assert time.monotonic() < deadline, "never recovered"
            time.sleep(0.05)
        assert not eng.stalled
    eng.stop()
