"""The port's web frontend and chain-server client against the reference
package's: each package's chain server over its engine (``llama-tiny``,
float32, CPU, the same numpy parameters carried across by
``params_from_numpy``) with the hash embedder and an exact store, each
package's frontend in front of its chain server, and each package's
``ChatClient`` against both chain servers. Then the client's stream
reading against scripted servers (error frames split across reads, a
block that arrives short), its typed errors, the pages and static files,
and speech (gated on the Riva client, degraded without it).

Tolerances: texts, hits, statuses, error fields and bytes exact."""

import asyncio
import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch
from aiohttp import web

from generativeaiexamples_tpu_torch.frontend import chat_client
from generativeaiexamples_tpu_torch.frontend.chat_client import (
    ChainServerError, ChatClient)
from generativeaiexamples_tpu_torch.frontend.server import \
    create_app as frontend_app
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

from generativeaiexamples_tpu.frontend import chat_client as jchat_client
from generativeaiexamples_tpu.frontend.server import \
    create_app as jfrontend_app

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC = os.path.join(ROOT, "generativeaiexamples_tpu_torch", "frontend",
                      "static")
JSTATIC = os.path.join(ROOT, "generativeaiexamples_tpu", "frontend",
                       "static")
ENGINE_KW = dict(max_slots=2, max_input_length=448, max_output_length=32,
                 prefill_buckets=(64, 128, 256, 448), page_size=16,
                 dtype="float32", kv_pool_tokens=None, max_queue=8)
CHAIN = {"llm": {"model_engine": "echo"},
         "embeddings": {"model_engine": "hash", "dimensions": 64},
         "text_splitter": {"chunk_size": 100, "chunk_overlap": 20},
         "retriever": {"top_k": 2, "max_context_tokens": 100}}
QUESTION = "How is a replica picked?"
TIMEOUT = 120
CLIENTS = {"port": ChatClient, "ref": jchat_client.ChatClient}
PAIRS = [(c, s) for c in ("port", "ref") for s in ("port", "ref")]


@contextlib.contextmanager
def _serve(app):
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


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.read().decode()


def _upload(base, path, route="/api/upload"):
    body, ctype = chat_client.multipart_body(path)
    req = urllib.request.Request(base + route, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def make_pptx(path):
    a = 'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main"'
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ppt/slides/slide1.xml",
                   f"<p:sld {a} xmlns:p=\"p\"><a:t>Replica heartbeat deck: "
                   f"the router drains a replica before a rollout.</a:t>"
                   f"</p:sld>")
    return str(path)


def make_docx(path):
    w = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("word/document.xml",
                   f"<w:document {w}><w:body><w:p><w:r><w:t>Quarterly "
                   f"kernel memo: split-K merges partial sums.</w:t></w:r>"
                   f"</w:p></w:body></w:document>")
    return str(path)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Per package: engine, chain server (router.md uploaded), frontend."""
    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JEngineLLM
    from generativeaiexamples_tpu.chains.server import create_app as jchain
    from generativeaiexamples_tpu.embed.encoder import \
        HashEmbedder as JHash
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import \
        QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
    from generativeaiexamples_tpu_torch.models.convert import \
        params_from_numpy
    from generativeaiexamples_tpu_torch.models.tokenizer import \
        ByteTokenizer
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    jparams = jllama.init_params(JCFG, jax.random.key(7), dtype=jnp.float32)
    eng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                   torch.float32, cfg=LLAMA_TINY),
                 LLAMA_TINY, ByteTokenizer(), EngineConfig(**ENGINE_KW),
                 device="cpu")
    jeng = JEngine(jparams, JCFG, JTok(), JConfig(**ENGINE_KW))
    bots = {"port": QAChatbot(llm=EngineLLM(eng), embedder=HashEmbedder(64),
                              config=from_dict(AppConfig, CHAIN),
                              fused_rag=False),
            "ref": JBot(llm=JEngineLLM(jeng), embedder=JHash(64),
                        config=jfrom_dict(JAppConfig, CHAIN),
                        fused_rag=False)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("run")))
        mp.delenv("RIVA_API_URI", raising=False)
        apps = {"port": create_app(bots["port"], str(
                    tmp_path_factory.mktemp("port_up"))),
                "ref": jchain(bots["ref"], str(
                    tmp_path_factory.mktemp("ref_up")))}
        with _serve(apps["port"]) as port, _serve(apps["ref"]) as ref:
            fronts = {"port": frontend_app(ChatClient(port)),
                      "ref": jfrontend_app(jchat_client.ChatClient(ref))}
            with _serve(fronts["port"]) as fport, \
                    _serve(fronts["ref"]) as fref:
                doc = os.path.join(ROOT, "docs", "router.md")
                ChatClient(port).upload_documents([doc])
                jchat_client.ChatClient(ref).upload_documents([doc])
                yield {"chain": {"port": port, "ref": ref},
                       "front": {"port": fport, "ref": fref},
                       "bots": bots, "engines": {"port": eng, "ref": jeng}}
    eng.stop()
    jeng.stop()


@pytest.fixture(scope="module")
def greedy(stack):
    """The reference chain server's own /generate text for QUESTION."""
    text = _post(stack["chain"]["ref"] + "/generate", {
        "question": QUESTION, "use_knowledge_base": True, "num_tokens": 24})
    assert len(text) > 3
    return text


@pytest.mark.parametrize("client,server", PAIRS)
def test_chat_client_predict_and_search_match_the_reference(stack, greedy,
                                                            client, server):
    c = CLIENTS[client](stack["chain"][server])
    chunks = list(c.predict(QUESTION, num_tokens=24))
    assert chunks[-1] is None and None not in chunks[:-1]
    assert "".join(chunks[:-1]) == greedy
    assert c.last_error is None and c.last_request_id
    hits = c.search(QUESTION, num_docs=2, request_id="fixed-id")
    assert c.last_request_id == "fixed-id"
    want = jchat_client.ChatClient(stack["chain"]["ref"]).search(QUESTION, 2)
    assert [(h["source"], h["content"]) for h in hits] == \
        [(h["source"], h["content"]) for h in want]
    assert {h["source"] for h in hits} == {"router.md"}


def test_frontend_generate_and_search_proxy_the_chain_server(stack, greedy):
    """/api/generate is the chain server's /generate text and /api/search
    its /documentSearch body, through either package's frontend."""
    for side in ("port", "ref"):
        front, chain = stack["front"][side], stack["chain"][side]
        assert _post(front + "/api/generate", {
            "question": QUESTION, "use_knowledge_base": True,
            "num_tokens": 24}) == greedy
        body = {"content": QUESTION, "num_docs": 2}
        assert json.loads(_post(front + "/api/search", body)) == \
            json.loads(_post(chain + "/documentSearch", body))
    no_kb = {s: _post(stack["front"][s] + "/api/generate", {
        "question": QUESTION, "use_knowledge_base": False, "num_tokens": 16})
        for s in ("port", "ref")}
    assert no_kb["port"] == no_kb["ref"] and no_kb["port"] != greedy


def test_frontend_uploads_pptx_and_docx(stack, tmp_path):
    """Both documents go through /api/upload to the chain server, which
    reads them with the assistant's parsers; /documentSearch then finds
    each; the knowledge-base table lists them."""
    deck = make_pptx(tmp_path / "deck.pptx")
    memo = make_docx(tmp_path / "memo.docx")
    found = {}
    for side in ("port", "ref"):
        front = stack["front"][side]
        for path in (deck, memo):
            assert _upload(front, path) == {
                "filename": os.path.basename(path), "status": "ingested"}
        table = json.loads(urllib.request.urlopen(
            front + "/api/kb", timeout=TIMEOUT).read())
        assert [e["filename"] for e in table[-2:]] == ["deck.pptx",
                                                       "memo.docx"]
        found[side] = [
            [(h["source"], h["content"]) for h in json.loads(_post(
                stack["chain"][side] + "/documentSearch",
                {"content": q, "num_docs": 1}))]
            for q in ("Replica heartbeat deck: the router drains a replica "
                      "before a rollout.",
                      "Quarterly kernel memo: split-K merges partial sums.")]
    assert found["port"] == found["ref"]
    assert [hits[0][0] for hits in found["port"]] == ["deck.pptx",
                                                      "memo.docx"]
    assert "[slide 1]" in found["port"][0][0][1]


# --------------------------------------------- the client against scripts

ERROR_TAIL = ('\n[error] engine failed mid-stream\n\nevent: error\ndata: '
              + json.dumps({"message": "engine failed",
                            "error": "EngineError"}) + "\n\n")


@contextlib.contextmanager
def _scripted(pieces, pause=0.0, status=200, headers=None, body=None):
    """A chain server whose /generate writes ``pieces`` one by one (a
    ``pause`` after the first); with ``body``, every route answers
    ``status`` with it."""
    async def generate(request):
        if body is not None:
            return web.Response(status=status, text=body,
                                headers=headers or {})
        resp = web.StreamResponse()
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        for i, piece in enumerate(pieces):
            await resp.write(piece.encode())
            await asyncio.sleep(pause if i == 0 else 0.01)
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_post("/generate", generate)
    app.router.add_post("/documentSearch", generate)
    with _serve(app) as base:
        yield base


@pytest.mark.parametrize("split", [1, 3, 7, 16, 40])
def test_error_frame_split_across_reads_is_caught(split):
    """The marker ``\\n[error]`` arriving in pieces of any size is never
    yielded as answer text; the parsed error is the reference's."""
    raw = ("Partial answer über alles" + ERROR_TAIL).encode()
    out = {}

    async def generate(request):
        resp = web.StreamResponse()
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        for i in range(0, len(raw), split):
            await resp.write(raw[i:i + split])
            await asyncio.sleep(0.002)
        await resp.write_eof()
        return resp
    app = web.Application()
    app.router.add_post("/generate", generate)
    with _serve(app) as base:
        for side, cls in CLIENTS.items():
            errs = []
            c = cls(base)
            chunks = list(c.predict("q", request_id="rid-split",
                                    on_error=errs.append))
            out[side] = ("".join(chunks[:-1]), c.last_error, errs)
    assert out["port"][0] == out["ref"][0] == "Partial answer über alles"
    assert out["port"][1]["message"] == "engine failed"
    assert out["port"][1:] == out["ref"][1:]


def test_short_blocks_are_delivered_without_waiting():
    """A block shorter than 16 bytes is yielded when it arrives (less the
    held-back marker-length tail), not when 16 bytes have gathered; the
    final partial block comes out at the end of the body."""
    with _scripted(["abcdefghij", "klm"], pause=1.5) as base:
        c = ChatClient(base)
        t0 = time.monotonic()
        gen = c.predict("q")
        first = next(gen)
        waited = time.monotonic() - t0
        rest = list(gen)
    assert first == "abc" and waited < 1.0
    assert first + "".join(rest[:-1]) == "abcdefghijklm" and rest[-1] is None


def test_structured_errors_match_the_reference():
    err = {"error": {"type": "queue_full", "message": "try later"},
           "request_id": "rid-7"}
    with _scripted([], status=429, headers={"Retry-After": "2.5"},
                   body=json.dumps(err)) as base:
        caught = {}
        for side, cls in CLIENTS.items():
            with pytest.raises(Exception) as exc:
                list(cls(base).predict("q"))
            e = exc.value
            caught[side] = (type(e).__name__, str(e), e.err_type,
                            e.request_id, e.retry_after_s)
        with pytest.raises(ChainServerError) as exc:
            ChatClient(base).search("q")
        assert isinstance(exc.value, urllib.error.HTTPError)
        assert exc.value.code == 429
    assert caught["port"] == caught["ref"] == (
        "ChainServerError", "HTTP 429 queue_full: try later (request rid-7)",
        "queue_full", "rid-7", 2.5)
    with _scripted([], status=500, body="plain failure") as base:
        with pytest.raises(urllib.error.HTTPError) as exc:
            ChatClient(base).search("q")
        assert not isinstance(exc.value, ChainServerError)
        assert exc.value.code == 500
        with pytest.raises(requests.HTTPError):
            jchat_client.ChatClient(base).search("q")


# ------------------------------------------------------- pages and speech

def test_pages_and_static_files(stack):
    """The pages and static files are the port's own copies: the
    reference's bytes, titled without the TPU."""
    base = stack["front"]["port"]
    assert sorted(os.listdir(STATIC)) == sorted(os.listdir(JSTATIC))
    for name in os.listdir(STATIC):
        ours = open(os.path.join(STATIC, name), "rb").read()
        assert ours == open(os.path.join(JSTATIC, name), "rb").read() \
            .replace(b"TPU RAG", b"RAG")
        assert b"TPU" not in ours
    for path, name in (("/content/converse", "converse.html"),
                       ("/content/kb", "kb.html"),
                       ("/static/style.css", "style.css")):
        with urllib.request.urlopen(base + path, timeout=TIMEOUT) as resp:
            assert resp.read() == open(os.path.join(STATIC, name),
                                       "rb").read()
    with urllib.request.urlopen(base + "/", timeout=TIMEOUT) as resp:
        assert resp.url.endswith("/content/converse")
    with urllib.request.urlopen(base + "/health", timeout=TIMEOUT) as resp:
        assert json.loads(resp.read()) == {"status": "ok"}


def test_speech_is_gated_on_the_riva_client(monkeypatch):
    import sys
    from generativeaiexamples_tpu_torch.frontend.speech import (ASRClient,
                                                                TTSClient)
    monkeypatch.setitem(sys.modules, "riva", None)
    monkeypatch.setitem(sys.modules, "riva.client", None)
    with pytest.raises(ConfigError, match="riva"):
        ASRClient()
    with pytest.raises(ConfigError, match="riva"):
        TTSClient()


class FakeASR:
    def transcribe(self, audio):
        return f"transcript of {len(audio)} bytes"


class FakeTTS:
    def synthesize(self, text):
        return b"RIFFfake-wav:" + text.encode()[:16]


@pytest.mark.parametrize("configured", [True, False],
                         ids=["clients", "riva_unset_or_missing"])
def test_speech_routes_match_the_reference(monkeypatch, configured):
    """With speech clients the routes transcribe and synthesize; with
    ``RIVA_API_URI`` unset, or set without the Riva package, speech is off
    (config false, 501) and the UI still serves."""
    out = {}
    for side, make in (("port", frontend_app), ("ref", jfrontend_app)):
        for env in ((None, "localhost:50051") if not configured else
                    (None,)):
            if env:
                monkeypatch.setenv("RIVA_API_URI", env)
                monkeypatch.setitem(__import__("sys").modules, "riva", None)
            else:
                monkeypatch.delenv("RIVA_API_URI", raising=False)
            client = CLIENTS[side]("http://127.0.0.1:9")
            app = (make(client, asr=FakeASR(), tts=FakeTTS()) if configured
                   else make(client))
            with _serve(app) as base:
                got = [json.loads(urllib.request.urlopen(
                    base + "/api/speech/config", timeout=TIMEOUT).read())]
                for path, data in (("/api/speech/transcribe", b"audio-bytes"),
                                   ("/api/speech/tts",
                                    json.dumps({"text": "hello"}).encode())):
                    try:
                        with urllib.request.urlopen(urllib.request.Request(
                                base + path, data=data),
                                timeout=TIMEOUT) as resp:
                            got.append((resp.status,
                                        resp.headers["Content-Type"],
                                        resp.read()))
                    except urllib.error.HTTPError as exc:
                        got.append(exc.code)
            out.setdefault(side, []).append(got)
    assert out["port"] == out["ref"]
    if configured:
        assert out["port"][0] == [
            {"asr": True, "tts": True},
            (200, "application/json; charset=utf-8",
             b'{"text": "transcript of 11 bytes"}'),
            (200, "audio/wav", b"RIFFfake-wav:hello")]
    else:
        assert out["port"] == [[{"asr": False, "tts": False}, 501, 501]] * 2
