"""The port's assistant package against the reference package's: the
pptx/docx parsers and the chain readers on archives built here with
``zipfile``, conversation memory, feedback, the fact-check guardrail and
the ``MultimodalAssistant`` example over a scripted LLM; then the slice as
a whole — each package's assistant behind its chain server over its
engine (``llama-tiny``, float32, CPU, the same numpy parameters carried
across by ``params_from_numpy``) with the hash embedder and an exact
store, fed the same deck through ``/uploadDocument``.

Tolerances: texts, sources, prompts and parsed structures exact; scores
within 1e-6."""

import asyncio
import contextlib
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request
import uuid
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu_torch.assistant import (ConversationMemory,
                                                      FeedbackStore,
                                                      MultimodalAssistant,
                                                      fact_check)
from generativeaiexamples_tpu_torch.assistant import parsers
from generativeaiexamples_tpu_torch.chains.llm import LLM
from generativeaiexamples_tpu_torch.chains.readers import read_document
from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
from generativeaiexamples_tpu_torch.utils.configuration import from_dict

from generativeaiexamples_tpu import assistant as jassistant
from generativeaiexamples_tpu.assistant import parsers as jparsers
from generativeaiexamples_tpu.chains.llm import LLM as JLLM
from generativeaiexamples_tpu.chains.readers import \
    read_document as jread_document

TIMEOUT = 120
_A = 'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main"'
_P = 'xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main"'
_W = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'
_REL = 'xmlns="http://schemas.openxmlformats.org/package/2006/relationships"'
_T = "http://schemas.openxmlformats.org/officeDocument/2006/relationships/"


def _slide(*texts):
    runs = "".join(f"<a:p><a:r><a:t>{t}</a:t></a:r></a:p>" for t in texts)
    return f"<p:sld {_P} {_A}><p:cSld><p:spTree>{runs}</p:spTree></p:cSld>" \
           f"</p:sld>"


def _rels(*targets):
    body = "".join(f'<Relationship Id="rId{i}" Type="{_T}{kind}" '
                   f'Target="{target}"/>'
                   for i, (kind, target) in enumerate(targets, 2))
    return f"<Relationships {_REL}>{body}</Relationships>"


def make_pptx(path, slides=3):
    """A deck of ``slides`` slides: text runs on each, an image and a video
    on the first, and speaker notes whose file numbers follow creation
    order, not slide order (the last slide's notes are notesSlide1)."""
    with zipfile.ZipFile(path, "w") as z:
        for i in range(1, slides + 1):
            z.writestr(f"ppt/slides/slide{i}.xml", _slide(
                f"Slide {i}: paged attention", f"The KV pool has {i * 128} "
                f"tokens per page group.", "Decode rounds batch slots."))
        first = [("image", "../media/image1.png"),
                 ("video", "../media/movie1.mp4")]
        last = [("notesSlide", "../notesSlides/notesSlide1.xml"),
                ("image", "../media/image2.jpeg")]
        if slides > 1:
            z.writestr("ppt/slides/_rels/slide1.xml.rels", _rels(*first))
            first = []
        z.writestr(f"ppt/slides/_rels/slide{slides}.xml.rels",
                   _rels(*first, *last))
        z.writestr("ppt/notesSlides/notesSlide1.xml",
                   _slide("Mention the split-K pass.", "7"))
        z.writestr("ppt/media/image1.png", b"\x89PNGfake")
        z.writestr("ppt/media/image2.jpeg", b"\xff\xd8fake")
        z.writestr("ppt/media/movie1.mp4", b"fakemp4")
    return str(path)


def make_docx(path):
    body = (f"<w:document {_W}><w:body>"
            "<w:p><w:r><w:t>The int4 kernel reads packed weights.</w:t>"
            "</w:r></w:p><w:p><w:r><w:t>Groups of </w:t></w:r>"
            "<w:r><w:t>128 share a scale.</w:t></w:r></w:p><w:p/>"
            "<w:tbl><w:tr><w:tc><w:p><w:r><w:t>cell one</w:t></w:r></w:p>"
            "</w:tc></w:tr></w:tbl></w:body></w:document>")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("word/document.xml", body)
    return str(path)


# ---------------------------------------------------------------- parsers

@pytest.mark.parametrize("slides", [1, 3])
def test_pptx_parsers_match_the_reference(tmp_path, slides):
    path = make_pptx(tmp_path / "deck.pptx", slides)
    ours = [dataclasses.asdict(s) for s in parsers.parse_pptx(path)]
    assert ours == [dataclasses.asdict(s) for s in jparsers.parse_pptx(path)]
    assert [s["index"] for s in ours] == list(range(1, slides + 1))
    assert ours[0]["images"] == ["image1.png"] + (
        ["image2.jpeg"] if slides == 1 else [])
    assert ours[-1]["notes"] == "Mention the split-K pass."
    assert parsers.read_pptx(path) == jparsers.read_pptx(path)
    assert read_document(path) == jread_document(path) == \
        parsers.read_pptx(path)
    out = tmp_path / "media"
    got = parsers.extract_images(path, str(out / "port"))
    want = jparsers.extract_images(path, str(out / "ref"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_docx_readers_match_the_reference(tmp_path):
    path = make_docx(tmp_path / "notes.docx")
    text = parsers.read_docx(path)
    assert text == jparsers.read_docx(path) == read_document(path) == \
        jread_document(path)
    assert text.splitlines() == ["The int4 kernel reads packed weights.",
                                 "Groups of 128 share a scale.", "cell one"]


# ----------------------------------------------------- memory and feedback

@settings(max_examples=60, deadline=None)
@given(turns=st.lists(st.tuples(st.text(max_size=40), st.text(max_size=40)),
                      max_size=10),
       max_turns=st.integers(1, 8), max_chars=st.integers(0, 200))
def test_memory_renders_as_the_reference(turns, max_turns, max_chars):
    ours = ConversationMemory(max_turns=max_turns, max_chars=max_chars)
    ref = jassistant.ConversationMemory(max_turns=max_turns,
                                        max_chars=max_chars)
    for q, a in turns:
        ours.add(q, a)
        ref.add(q, a)
        assert ours.render() == ref.render() and len(ours) == len(ref)
    ours.clear()
    assert len(ours) == 0 and ours.render() == ""


def test_feedback_store_matches_the_reference(tmp_path):
    stores = {"port": FeedbackStore(str(tmp_path / "port" / "fb.jsonl")),
              "ref": jassistant.FeedbackStore(str(tmp_path / "ref" /
                                                  "fb.jsonl"))}
    assert stores["port"].load() == []
    for s in stores.values():
        s.record("q", "a", 4, comment="good", sources=["deck.pptx"])
        s.record("q2", "a2", "1")
    loaded = {k: [{f: v for f, v in e.items() if f != "ts"}
                  for e in s.load()] for k, s in stores.items()}
    assert loaded["port"] == loaded["ref"]
    assert [e["rating"] for e in loaded["port"]] == [4, 1]


# -------------------------------------------------------------- guardrail

def _scripted(base):
    class Scripted(base):
        def __init__(self, responses):
            self.responses = list(responses)
            self.prompts = []
            self.kwargs = []

        def stream(self, prompt, max_tokens=256, stop=None,
                   temperature=1.0, top_k=1, top_p=0.0):
            self.prompts.append(prompt)
            self.kwargs.append((max_tokens, stop, temperature, top_k))
            idx = min(len(self.prompts) - 1, len(self.responses) - 1)
            yield self.responses[idx]
    return Scripted


ScriptedLLM, JScriptedLLM = _scripted(LLM), _scripted(JLLM)


@pytest.mark.parametrize("reply", [
    "VERDICT: TRUE All claims match.", "verdict:false Claim 2 is invented.",
    "cannot say", "Preamble. VERDICT: FALSE and VERDICT: TRUE"])
def test_fact_check_matches_the_reference(reply):
    ours, ref = ScriptedLLM([reply]), JScriptedLLM([reply])
    a = fact_check(ours, "ctx", "q", "resp")
    b = jassistant.fact_check(ref, "ctx", "q", "resp")
    assert (a.supported, a.explanation) == (b.supported, b.explanation)
    assert ours.prompts == ref.prompts and ours.kwargs == ref.kwargs


# -------------------------------------------------------------- assistant

CHAIN = {"llm": {"model_engine": "echo"},
         "embeddings": {"model_engine": "hash", "dimensions": 64},
         "vector_store": {"name": "exact"},
         "text_splitter": {"chunk_size": 60, "chunk_overlap": 10},
         "retriever": {"top_k": 2, "max_context_tokens": 200}}


def _assistants(port_llm, ref_llm, tmp_path, check_facts=True):
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    jchain = {**CHAIN, "llm": {"model_engine": "echo"}}
    ours = MultimodalAssistant(
        llm=port_llm, config=from_dict(AppConfig, CHAIN),
        check_facts=check_facts, feedback_path=str(tmp_path / "p.jsonl"))
    ref = jassistant.MultimodalAssistant(
        llm=ref_llm, config=jfrom_dict(JAppConfig, jchain),
        check_facts=check_facts, feedback_path=str(tmp_path / "r.jsonl"))
    return ours, ref


@pytest.mark.parametrize("verdict", ["VERDICT: TRUE Slide 1 says so.",
                                     "VERDICT: FALSE Not in the deck.",
                                     "no verdict"])
def test_assistant_chains_match_the_reference(tmp_path, verdict):
    ours, ref = _assistants(ScriptedLLM(["The pool pages hold KV.", verdict,
                                         "A follow-up."]),
                            JScriptedLLM(["The pool pages hold KV.", verdict,
                                          "A follow-up."]), tmp_path)
    deck = make_pptx(tmp_path / "deck.pptx")
    doc = make_docx(tmp_path / "notes.docx")
    md = tmp_path / "extra.md"
    md.write_text("Speculative decoding verifies drafts in one round.")
    for bot in (ours, ref):
        bot.ingest_docs(deck, "deck.pptx")
        bot.ingest_docs(doc, "notes.docx")
        bot.ingest_docs(str(md), "extra.md")
    assert len(ours.index) == len(ref.index) > 4
    for q in ("What does the KV pool hold?", "What do groups share?"):
        a, b = ours.document_search(q, 4), ref.document_search(q, 4)
        assert [(h["source"], h["content"]) for h in a] == \
            [(h["source"], h["content"]) for h in b]
        np.testing.assert_allclose([h["score"] for h in a],
                                   [h["score"] for h in b], atol=1e-6)
    assert any("(slide " in h["source"]
               for h in ours.document_search("paged attention", 4))
    first = "".join(ours.rag_chain("What does the KV pool hold?", 64))
    assert first == "".join(ref.rag_chain("What does the KV pool hold?", 64))
    follow = "".join(ours.llm_chain("", "and the pages?", 32))
    assert follow == "".join(ref.llm_chain("", "and the pages?", 32))
    assert ours.llm.prompts == ref.llm.prompts
    assert ours.llm.kwargs == ref.llm.kwargs
    assert "Conversation so far:" in ours.llm.prompts[-1]
    assert ours.memory.render() == ref.memory.render()
    assert ours.record_feedback("q", first, 5, "ok")["rating"] == 5


def test_assistant_is_a_chain_server_example():
    from generativeaiexamples_tpu_torch.chains.server import discover_example
    assert discover_example("generativeaiexamples_tpu_torch.assistant."
                            "assistant") is MultimodalAssistant


# ------------------------------------------ the slice as a whole (engines)

ENGINE_KW = dict(max_slots=2, max_input_length=448, max_output_length=32,
                 prefill_buckets=(64, 128, 256, 448), page_size=16,
                 dtype="float32", kv_pool_tokens=None, max_queue=8)
QUESTION = "What does the KV pool hold per page group?"


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


def _post(url, body=None, data=None, headers=None):
    if body is not None:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _upload(base, path):
    boundary = uuid.uuid4().hex
    data = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"{os.path.basename(path)}\"\r\n\r\n").encode() + \
        open(path, "rb").read() + f"\r\n--{boundary}--\r\n".encode()
    return _post(base + "/uploadDocument", data=data, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})


def test_served_assistant_answers_the_reference_greedy_text(
        tmp_path_factory, monkeypatch):
    """Each package's assistant behind its chain server over its engine:
    the deck uploaded to each, then /generate with the knowledge base
    gives the same greedy text, which is the engine's greedy text for the
    prompt the assistant assembled; /documentSearch names the slides."""
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JEngineLLM
    from generativeaiexamples_tpu.chains.server import create_app as jcreate
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
    from generativeaiexamples_tpu_torch.models.convert import \
        params_from_numpy
    from generativeaiexamples_tpu_torch.models.tokenizer import \
        ByteTokenizer

    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("run")))
    jparams = jllama.init_params(JCFG, jax.random.key(3), dtype=jnp.float32)
    eng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                   torch.float32, cfg=LLAMA_TINY),
                 LLAMA_TINY, ByteTokenizer(), EngineConfig(**ENGINE_KW),
                 device="cpu")
    jeng = JEngine(jparams, JCFG, JTok(), JConfig(**ENGINE_KW))
    tmp = tmp_path_factory.mktemp("assistant")
    ours, ref = _assistants(EngineLLM(eng), JEngineLLM(jeng), tmp,
                            check_facts=False)
    deck = make_pptx(tmp / "deck.pptx")
    texts, hits = {}, {}
    with _serve(create_app(ours, str(tmp / "port_up"))) as port, \
            _serve(jcreate(ref, str(tmp / "ref_up"))) as jref:
        for side, base in (("port", port), ("ref", jref)):
            assert _upload(base, deck)[0] == 200
            status, text = _post(base + "/documentSearch",
                                 {"content": QUESTION, "num_docs": 2})
            assert status == 200
            hits[side] = [(h["source"], h["content"])
                          for h in json.loads(text)]
        # The prompt the assistant will assemble (memory still empty).
        docs = ours.index.similarity_search(QUESTION, k=2)
        prompt = ours._prompt("\n\n".join(d.text for d in docs), QUESTION)
        for side, base in (("port", port), ("ref", jref)):
            status, texts[side] = _post(base + "/generate", {
                "question": QUESTION, "use_knowledge_base": True,
                "num_tokens": 24})
            assert status == 200
    eng.stop()
    jeng.stop()
    assert hits["port"] == hits["ref"]
    assert all("(slide " in s for s, _ in hits["port"])
    assert texts["port"] == texts["ref"] and len(texts["port"]) > 3
    eng.clear_prefix_cache()
    want = eng.generate_text(prompt, SamplingParams(
        max_tokens=24, top_k=1, stop_words=["</s>", "[INST]"]))
    assert texts["port"] == want
    eng.close()
