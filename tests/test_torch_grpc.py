"""The port's gRPC ``LLMService`` against the reference package's: the
port's ``serve_grpc`` over the port's engine and the reference's over the
JAX ``Engine``, both on ``llama-tiny`` (float32, CPU) with the same numpy
parameters carried across by ``params_from_numpy``, and the hash embedder.
Each package's ``GrpcLLMClient`` runs against both servers (the two
generated message modules share one descriptor).

Tolerances: greedy texts, status codes and embeddings exact;
``SamplingParams`` equal field by field."""

import dataclasses
import sys
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.serving import grpc_server
from generativeaiexamples_tpu_torch.serving.protos import \
    llm_service_pb2 as pb
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

from generativeaiexamples_tpu.serving import grpc_server as jgrpc_server
from generativeaiexamples_tpu.serving.protos import \
    llm_service_pb2 as jpb

ENGINE_KW = dict(max_slots=4, max_input_length=64, max_output_length=32,
                 prefill_buckets=(16, 32, 64), dtype="float32", max_queue=64,
                 page_size=16)
PROMPT = "hello tpu and gpu"
NEW = 16
MODULES = {"port": grpc_server, "ref": jgrpc_server}
PAIRS = [(c, s) for c in ("port", "ref") for s in ("port", "ref")]


@pytest.fixture(scope="module")
def served():
    from generativeaiexamples_tpu.embed.encoder import \
        HashEmbedder as JHash
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok

    jparams = jllama.init_params(JCFG, jax.random.key(5), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                               torch.float32, cfg=LLAMA_TINY)
    engines = {"port": Engine(params, LLAMA_TINY, ByteTokenizer(),
                              EngineConfig(**ENGINE_KW), device="cpu"),
               "ref": JEngine(jparams, JCFG, JTok(), JConfig(**ENGINE_KW))}
    embedders = {"port": HashEmbedder(dim=32), "ref": JHash(dim=32)}
    servers = {side: MODULES[side].serve_grpc(
        engines[side], "llama-tiny", embedders[side], max_output=32,
        host="127.0.0.1", port=0) for side in ("port", "ref")}
    targets = {side: f"127.0.0.1:{s._bound_port}"
               for side, s in servers.items()}
    clients = {(c, s): MODULES[c].GrpcLLMClient(targets[s])
               for c, s in PAIRS}
    for c in clients.values():
        c.wait_ready()
    yield {"clients": clients, "engines": engines, "targets": targets}
    for c in clients.values():
        c.close()
    for side in servers:
        servers[side].stop(grace=None)
        engines[side].stop()


@pytest.fixture(scope="module")
def greedy(served):
    text = served["clients"][("ref", "ref")].generate(PROMPT,
                                                      max_tokens=NEW)
    assert len(text) > 3
    return text


@pytest.mark.parametrize("client,server", PAIRS)
def test_generate_unary_and_stream_give_the_reference_greedy_text(
        served, greedy, client, server):
    c = served["clients"][(client, server)]
    health = c.wait_ready()
    assert health.ready and health.model_name == "llama-tiny"
    # Absent fields are the ensemble's defaults: greedy.
    assert c.generate(PROMPT, max_tokens=NEW) == greedy
    assert c.generate(PROMPT, max_tokens=NEW, top_k=1,
                      temperature=1.0) == greedy
    chunks = list(c.generate_stream(PROMPT, max_tokens=NEW))
    assert len(chunks) > 1 and "".join(chunks) == greedy


def test_final_response_matches_the_reference(served):
    """The streamed messages (deltas, then the final flag with the finish
    reason) and the unary message are the reference's."""
    out = {}
    for side in ("port", "ref"):
        stub = grpc.insecure_channel(served["targets"][side]).unary_stream(
            f"/{grpc_server.SERVICE}/GenerateStream",
            request_serializer=pb.GenerateRequest.SerializeToString,
            response_deserializer=pb.GenerateResponse.FromString)
        out[side] = [(m.text_output, m.final, m.finish_reason, m.model_name)
                     for m in stub(pb.GenerateRequest(text_input=PROMPT,
                                                      max_tokens=NEW),
                                   timeout=60)]
    assert out["port"] == out["ref"]
    assert out["port"][-1][1:3] in ((True, "length"), (True, "eos"))


@pytest.mark.parametrize("client,server", PAIRS)
def test_invalid_arguments_match_the_reference(served, client, server):
    c = served["clients"][(client, server)]
    for kw in ({"text": "x" * 500, "max_tokens": 4},
               {"text": "ok", "length_penalty": 2.0},
               {"text": "ok", "beam_width": 2}):
        with pytest.raises(grpc.RpcError) as err:
            c.generate(kw.pop("text"), **kw)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT


@pytest.mark.parametrize("client,server", PAIRS)
def test_embed_matches_the_reference(served, client, server):
    c = served["clients"][(client, server)]
    ref = served["clients"][("ref", "ref")]
    for mode in ("passage", "query"):
        got = c.embed(["alpha", "beta"], input_type=mode)
        assert got.shape == (2, 32)
        np.testing.assert_array_equal(got, ref.embed(["alpha", "beta"],
                                                     input_type=mode))
    np.testing.assert_array_equal(
        c.embed(["alpha"], "passage")[0],
        HashEmbedder(dim=32).embed_documents(["alpha"])[0])


def test_embed_without_embedder_is_unimplemented(served):
    eng = served["engines"]["port"]
    server = grpc_server.serve_grpc(eng, "llama-tiny", None,
                                    host="127.0.0.1", port=0)
    try:
        c = grpc_server.GrpcLLMClient(f"127.0.0.1:{server._bound_port}")
        with pytest.raises(grpc.RpcError) as err:
            c.embed(["x"])
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        c.close()
    finally:
        server.stop(grace=None)


def test_stream_cancel_frees_the_slot(served, monkeypatch):
    """The client cancelling a stream is the stop signal: the engine's
    stream finishes "cancelled" and its slot is released."""
    eng = served["engines"]["port"]
    streams = []
    orig = eng.stream_text

    def keep(*a, **kw):
        streams.append(orig(*a, **kw))
        return streams[-1]
    monkeypatch.setattr(eng, "stream_text", keep)
    stub = grpc.insecure_channel(served["targets"]["port"]).unary_stream(
        f"/{grpc_server.SERVICE}/GenerateStream",
        request_serializer=pb.GenerateRequest.SerializeToString,
        response_deserializer=pb.GenerateResponse.FromString)
    call = stub(pb.GenerateRequest(text_input=PROMPT, max_tokens=32,
                                   ignore_eos=True), timeout=60)
    assert not next(call).final
    call.cancel()
    deadline = time.monotonic() + 60
    s = streams[-1]
    while s.finish_reason is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert s.cancelled and s.finish_reason == "cancelled"
    assert len(s.token_ids) < 32
    while eng.stats["active_slots"] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng.stats["active_slots"] == 0


def test_without_grpc_the_front_end_is_refused(monkeypatch):
    """No ``grpcio``: the server, the client and the model server's CLI
    with a gRPC port raise ``ConfigError`` naming the package (the CLI
    before it builds anything); ``--grpc-port 0`` does not need it."""
    from generativeaiexamples_tpu_torch.serving import model_server
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ConfigError, match="grpcio"):
        grpc_server.serve_grpc(None, port=0)
    with pytest.raises(ConfigError, match="grpcio"):
        grpc_server.GrpcLLMClient("127.0.0.1:1")
    built = []
    monkeypatch.setattr(model_server, "build_services",
                        lambda *a, **kw: built.append(1) or 1 / 0)
    with pytest.raises(ConfigError, match="grpcio"):
        model_server.main(["llama-tiny", "--device", "cpu"])
    assert not built
    with pytest.raises(ZeroDivisionError):
        model_server.main(["llama-tiny", "--device", "cpu",
                           "--grpc-port", "0"])
    assert built == [1]


_REQUEST = st.builds(
    dict,
    text_input=st.text(max_size=8),
    max_tokens=st.integers(0, 600),
    temperature=st.sampled_from([0.0, 0.5, 1.0, 1.5]),
    top_k=st.integers(0, 50),
    top_p=st.sampled_from([0.0, 0.25, 0.9, 1.0]),
    repetition_penalty=st.sampled_from([0.0, 1.0, 1.25]),
    length_penalty=st.sampled_from([0.0, 1.0, 0.5]),
    beam_width=st.sampled_from([0, 1, 2]),
    random_seed=st.integers(0, 2 ** 40),
    stop_words=st.lists(st.text(max_size=4), max_size=3),
    bad_words=st.lists(st.text(max_size=4), max_size=3),
    ignore_eos=st.booleans())


def _outcome(mod, fields, max_output):
    try:
        return dataclasses.asdict(mod._params_from_request(
            pb.GenerateRequest(**fields), max_output))
    except ValueError as exc:
        return type(exc).__name__


@settings(max_examples=150, deadline=None)
@given(fields=_REQUEST, max_output=st.integers(1, 512))
def test_params_from_request_match_the_reference(fields, max_output):
    assert jpb.GenerateRequest is pb.GenerateRequest
    assert _outcome(grpc_server, fields, max_output) == \
        _outcome(jgrpc_server, fields, max_output)
