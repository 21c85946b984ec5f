"""The port's LangChain and LlamaIndex connectors against the reference
package's: each package's model server (HTTP, with the job routes) and
gRPC service over its engine (``llama-tiny``, float32, CPU, the same
numpy parameters carried across by ``params_from_numpy``) and the hash
embedder; each package's connector classes against both. Neither
langchain_core nor llama_index is installed, so both sides run on their
structural stand-ins.

Tolerances: greedy texts exact; embeddings exact (the same hash
arithmetic)."""

import asyncio
import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web

from generativeaiexamples_tpu_torch.integrations import (langchain_torch,
                                                         llamaindex_torch)

from generativeaiexamples_tpu.integrations import langchain_tpu
from generativeaiexamples_tpu.integrations import llamaindex_tpu

PROMPT = "integration prompt"
NEW = 12
LC = {"port": (langchain_torch.TorchLLM, langchain_torch.TorchJobsLLM,
               langchain_torch.TorchEmbeddings),
      "ref": (langchain_tpu.TpuLLM, langchain_tpu.TpuJobsLLM,
              langchain_tpu.TpuEmbeddings)}
LI = {"port": (llamaindex_torch.TorchLlamaIndexLLM,
               llamaindex_torch.TorchLlamaIndexEmbedding),
      "ref": (llamaindex_tpu.TpuLlamaIndexLLM,
              llamaindex_tpu.TpuLlamaIndexEmbedding)}
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
    assert started.wait(60), "the server did not start"
    try:
        yield f"http://127.0.0.1:{box['port']}"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from generativeaiexamples_tpu.embed.encoder import \
        HashEmbedder as JHash
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu.serving import grpc_server as jgrpc
    from generativeaiexamples_tpu.serving.model_server import \
        create_server_app as jcreate
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
    from generativeaiexamples_tpu_torch.models.convert import \
        params_from_numpy
    from generativeaiexamples_tpu_torch.models.tokenizer import \
        ByteTokenizer
    from generativeaiexamples_tpu_torch.serving import grpc_server
    from generativeaiexamples_tpu_torch.serving.model_server import \
        create_server_app

    kw = dict(max_slots=2, max_input_length=64, max_output_length=32,
              prefill_buckets=(16, 32, 64), dtype="float32", max_queue=16,
              page_size=16)
    jparams = jllama.init_params(JCFG, jax.random.key(2), dtype=jnp.float32)
    eng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                   torch.float32, cfg=LLAMA_TINY),
                 LLAMA_TINY, ByteTokenizer(), EngineConfig(**kw),
                 device="cpu")
    jeng = JEngine(jparams, JCFG, JTok(), JConfig(**kw))
    emb, jemb = HashEmbedder(dim=32), JHash(dim=32)
    grpcs = {"port": grpc_server.serve_grpc(eng, "llama-tiny", emb,
                                            max_output=32, host="127.0.0.1",
                                            port=0),
             "ref": jgrpc.serve_grpc(jeng, "llama-tiny", jemb, max_output=32,
                                     host="127.0.0.1", port=0)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("run")))
        with _serve(create_server_app(eng, emb, "llama-tiny")) as port, \
                _serve(jcreate(jeng, jemb, "llama-tiny")) as ref:
            yield {"http": {"port": port, "ref": ref},
                   "grpc": {s: f"127.0.0.1:{g._bound_port}"
                            for s, g in grpcs.items()}}
    for g in grpcs.values():
        g.stop(grace=None)
    eng.stop()
    jeng.stop()


@pytest.fixture(scope="module")
def greedy(served):
    text = langchain_tpu.TpuLLM(server_url=served["grpc"]["ref"],
                                mode="grpc", tokens=NEW)._call(PROMPT)
    assert len(text) > 3
    return text


@pytest.mark.parametrize("client,server", PAIRS)
@pytest.mark.parametrize("mode", ["grpc", "http"])
def test_llm_call_and_stream_give_the_reference_greedy_text(
        served, greedy, client, server, mode):
    llm = LC[client][0](server_url=served[mode][server], mode=mode,
                        tokens=NEW)
    assert llm._call(PROMPT) == greedy
    assert llm.invoke(PROMPT) == greedy
    chunks = list(llm.stream(PROMPT))
    assert len(chunks) > 1 and "".join(chunks) == greedy
    assert [c.text for c in llm._stream(PROMPT, stop=[])] == chunks


def test_llm_identity_and_defaults_match_the_reference(served):
    ours = langchain_torch.TorchLLM(server_url="x", mode="http")
    ref = langchain_tpu.TpuLLM(server_url="x", mode="http")
    assert langchain_torch.STOP_WORDS == langchain_tpu.STOP_WORDS == ["</s>"]
    assert ours._default_params == ref._default_params
    assert ours._identifying_params == ref._identifying_params
    assert (ours._llm_type, langchain_torch.TorchJobsLLM()._llm_type) == (
        "torch_llm", "torch_jobs_llm")
    assert ours._merged(None, {}) == ref._merged(None, {})
    assert langchain_torch.HAVE_LANGCHAIN is False
    assert llamaindex_torch.HAVE_LLAMAINDEX is False


@pytest.mark.parametrize("side", ["port", "ref"])
def test_http_mode_refuses_what_the_api_cannot_carry(served, side):
    llm = LC[side][0](server_url=served["http"]["port"], mode="http",
                      tokens=4, repetition_penalty=1.2)
    with pytest.raises(ValueError, match="mode='http' does not support"):
        llm._call(PROMPT)


@pytest.mark.parametrize("client,server", PAIRS)
def test_jobs_llm_gives_the_reference_greedy_text(served, greedy, client,
                                                  server):
    llm = LC[client][1](server_url=served["http"][server], tokens=NEW,
                        temperature=0, model_name="tiny",
                        poll_interval=0.02)
    assert llm._call(PROMPT, stop=["</s>"]) == greedy
    assert llm._resolved_model == "llama-tiny"
    with pytest.raises(ValueError, match="unknown model name"):
        LC[client][1](server_url=served["http"][server],
                      model_name="mistral")._call(PROMPT)


@pytest.mark.parametrize("client,server", PAIRS)
@pytest.mark.parametrize("mode", ["grpc", "http"])
def test_embeddings_match_the_reference(served, client, server, mode):
    emb = LC[client][2](server_url=served[mode][server], mode=mode)
    want = langchain_tpu.TpuEmbeddings(server_url=served["grpc"]["ref"],
                                       mode="grpc")
    docs = emb.embed_documents(["alpha doc", "beta doc"])
    assert len(docs) == 2 and len(docs[0]) == 32
    np.testing.assert_allclose(docs, want.embed_documents(["alpha doc",
                                                           "beta doc"]),
                               atol=1e-7)
    np.testing.assert_allclose(emb.embed_query("alpha doc"),
                               want.embed_query("alpha doc"), atol=1e-7)


@pytest.mark.parametrize("client,server", PAIRS)
@pytest.mark.parametrize("mode", ["grpc", "http"])
def test_llamaindex_llm_gives_the_reference_greedy_text(served, greedy,
                                                        client, server,
                                                        mode):
    llm = LI[client][0](server_url=served[mode][server], mode=mode,
                        tokens=NEW)
    assert llm.complete(PROMPT).text == greedy
    steps = list(llm.stream_complete(PROMPT))
    assert steps[-1].text == greedy
    assert "".join(s.delta for s in steps) == greedy
    assert (llm.metadata.context_window, llm.metadata.num_output) == (3000,
                                                                      NEW)


@pytest.mark.parametrize("client,server", PAIRS)
def test_llamaindex_embedding_matches_the_reference(served, client, server):
    emb = LI[client][1](server_url=served["grpc"][server], mode="grpc")
    want = llamaindex_tpu.TpuLlamaIndexEmbedding(
        server_url=served["grpc"]["ref"], mode="grpc")
    assert emb.get_query_embedding("hello") == \
        want.get_query_embedding("hello")
    assert emb.get_text_embedding("hello") == \
        want.get_text_embedding("hello")
    assert emb._get_text_embeddings(["a", "b"]) == \
        want._get_text_embeddings(["a", "b"])
    assert asyncio.run(emb._aget_query_embedding("x")) == \
        emb.get_query_embedding("x")
