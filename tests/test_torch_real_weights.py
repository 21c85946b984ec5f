"""The real-weights gate of the port: the committed golden-tiny checkpoint
(trained llama weights, hidden 64, 2 layers, GQA 4/2, head_dim 16, with
the real 32k sentencepiece vocabulary) through the port's import ->
quantize -> engine -> detokenizer -> scoring -> HTTP, on the CPU, held
against the JAX package on the same files.

Random weights are compute-identical but quality-blind: a real-vocabulary
detokenization bug or a quantization regression keeps every shape right.
Tolerances: ``llama.score`` NLL within 1e-4 of the JAX ``score`` (both
float32; the frameworks' summation orders differ); greedy tokens exact.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY as CFG
from generativeaiexamples_tpu_torch.models.import_hf import load_checkpoint
from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.serving import model_server
from generativeaiexamples_tpu_torch.serving.model_server import (
    build_services, create_server_app)
from generativeaiexamples_tpu_torch.utils.errors import (
    ConfigError)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tiny")

# A sentence the training corpus (docs/*.md) holds verbatim: the
# memorizing tiny model continues it with low perplexity.
CORPUS_SNIPPET = ("The stack is three services plus the subsystems they "
                  "share — the same topology as the reference RAG "
                  "pipeline")
ENGINE_KW = dict(max_slots=2, max_input_length=256, max_output_length=64,
                 prefill_buckets=(64, 128, 256), page_size=16,
                 dtype="float32", kv_pool_tokens=None)
PROMPTS = ["Paged KV caching shares", "Continuous batching admits",
           "The router sends each request"]


@pytest.fixture(autouse=True)
def weight_cache_in_tmp(tmp_path, monkeypatch):
    """``build_services(model_path=...)`` caches the served tree: keep it
    out of the home directory."""
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path / "wc"))


@pytest.fixture(scope="module")
def golden():
    params = load_checkpoint(GOLDEN, CFG, dtype=torch.float32, device="cpu")
    return params, get_tokenizer(GOLDEN)


@pytest.fixture(scope="module")
def jax_golden():
    import jax.numpy as jnp

    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    return jload(GOLDEN, JCFG, dtype=jnp.float32), jget(GOLDEN), JCFG


def _engine(params, tok, **kw):
    return Engine(params, CFG, tok, EngineConfig(**{**ENGINE_KW, **kw}),
                  device="cpu")


def _snippet_ids(tok):
    return torch.tensor([tok.encode(CORPUS_SNIPPET)], dtype=torch.int32)


def test_real_vocab_streams_nondegenerate_text(golden):
    """Serving end to end on the real vocabulary: an incremental,
    decodable, non-repeating stream, equal to decode(token_ids)."""
    params, tok = golden
    with _engine(params, tok) as eng:
        s = eng.stream_text(PROMPTS[0], SamplingParams(
            max_tokens=24, top_k=1, ignore_eos=True))
        chunks = list(s)
    text = "".join(chunks)
    assert len(text) > 20, text
    assert len(set(s.token_ids)) > 4, s.token_ids
    assert len([c for c in chunks if c]) > 1
    assert text == tok.decode(s.token_ids)


@pytest.mark.parametrize("chunk", [2048, 16], ids=["one-pass", "chunked"])
def test_score_matches_jax_and_beats_random(golden, jax_golden, chunk):
    """``llama.score`` on memorized text equals the JAX ``score`` within
    1e-4 per token (one pass, and chunks of 16 over a cache of 32), is
    under 6.0 trained and over 7.0 with random weights (ln V ~ 10.4)."""
    import jax.numpy as jnp

    from generativeaiexamples_tpu.models import llama as jllama
    params, tok = golden
    jparams, _, jcfg = jax_golden
    ids = _snippet_ids(tok)
    assert ids.shape[1] > 16
    nll = llama.score(params, CFG, ids, chunk=chunk)
    want = np.asarray(jllama.score(jparams, jcfg, jnp.asarray(ids.numpy()),
                                   chunk=chunk))
    assert nll.dtype == torch.float32 and nll.shape == (1, ids.shape[1] - 1)
    np.testing.assert_allclose(nll.numpy(), want, rtol=0, atol=1e-4)
    mean = float(nll.mean())
    assert mean < 6.0, mean
    rand = llama.init_params(CFG, seed=1, dtype=torch.float32)
    rand_nll = float(llama.score(rand, CFG, ids, chunk=chunk).mean())
    assert rand_nll > 7.0 and mean < rand_nll - 4.0, (mean, rand_nll)


def test_score_argument_checks(golden):
    params, _ = golden
    two = torch.tensor([[1, 5]], dtype=torch.int32)
    with pytest.raises(ValueError, match="at least 2"):
        llama.score(params, CFG, two[:, :1])
    with pytest.raises(ValueError, match="chunk"):
        llama.score(params, CFG, two, chunk=8)
    # A sequence-parallel mesh takes the ring (tests/test_torch_mesh_
    # serving.py), a tp mesh the tp forward (tests/test_torch_tp_features.
    # py); sp composed with tp is refused with the reference's message.
    from generativeaiexamples_tpu_torch.parallel.mesh import Mesh
    sp = Mesh(shape={"dp": 1, "pp": 1, "ep": 1, "sp": 2, "tp": 2}, world=4)
    with pytest.raises(ValueError, match="composing sp with tp"):
        llama.score(params, CFG, two, mesh=sp)


def test_quantization_preserves_quality(golden):
    """int8 weights move the memorized-text NLL by under 0.15; with an
    int8 KV pool too, the greedy continuation keeps the full-precision
    trajectory's first three tokens."""
    from generativeaiexamples_tpu_torch.ops.quant import quantize_params
    params, tok = golden
    ids = _snippet_ids(tok)
    base = float(llama.score(params, CFG, ids).mean())
    q8 = quantize_params(params, "int8")
    q8_nll = float(llama.score(q8, CFG, ids).mean())
    assert abs(q8_nll - base) < 0.15, (base, q8_nll)
    sp = SamplingParams(max_tokens=16, top_k=1, ignore_eos=True)
    prompt = "Continuous batching admits"
    with _engine(params, tok) as ref:
        a = ref.stream_text(prompt, sp)
        a_text = a.text()
    with _engine(q8, tok, kv_quant="int8") as quant:
        b = quant.stream_text(prompt, sp)
        b_text = b.text()
    assert a.token_ids[:3] == b.token_ids[:3], (a_text, b_text)
    assert len(b_text) > 10


def test_greedy_tokens_match_jax_engine(golden, jax_golden):
    """The port's engine and the JAX ``Engine`` on golden_tiny (float32,
    the same prompts submitted together): equal greedy tokens, equal
    text."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    params, tok = golden
    jparams, jtok, jcfg = jax_golden
    ids = [tok.encode(p) for p in PROMPTS]
    assert ids == [jtok.encode(p) for p in PROMPTS]
    eng = _engine(params, tok, max_slots=4)
    streams = [eng.submit(i, SamplingParams(max_tokens=20, top_k=1,
                                            ignore_eos=True)) for i in ids]
    with eng:
        texts = [s.text() for s in streams]
    with JEngine(jparams, jcfg, jtok, JConfig(**{**ENGINE_KW,
                                                 "max_slots": 4})) as jeng:
        jstreams = [jeng.submit(i, JParams(max_tokens=20, top_k=1,
                                           ignore_eos=True)) for i in ids]
        jtexts = [s.text() for s in jstreams]
    assert [s.token_ids for s in streams] == [s.token_ids for s in jstreams]
    assert texts == jtexts
    assert all(len(set(s.token_ids)) > 4 for s in streams)


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def test_checkpoint_server_completions_and_score(golden, monkeypatch):
    """``build_services(model_path=...)`` serves golden_tiny with its own
    tokenizer over HTTP: a streamed completion equal to
    decode(token_ids) of the same engine's greedy tokens, and /v1/score
    under 6.0 nats equal to ``llama.score`` (per token too), with the
    typed 4xx answers."""
    from conftest import serve_app
    params, tok = golden
    engine, name = build_services("llama-2-7b-chat", model_path=GOLDEN,
                                  device="cpu",
                                  engine_cfg=EngineConfig(**ENGINE_KW))
    assert engine.model_cfg == CFG and engine.tokenizer.vocab_size == 32000
    for k in ("embed", "final_norm", "lm_head"):
        assert torch.equal(engine.params[k], params[k])
    want = llama.score(params, CFG, _snippet_ids(tok))[0].double().numpy()
    monkeypatch.setenv("GAIE_MAX_SCORE_TOKENS", "64")
    with serve_app(create_server_app(engine, model_name=name)) as base:
        status, raw = _post(base + "/v1/completions", {
            "prompt": PROMPTS[0], "max_tokens": 12, "temperature": 0,
            "stream": True})
        assert status == 200
        events = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        text = "".join(json.loads(e)["choices"][0]["text"]
                       for e in events[:-1])
        ref = engine.submit(tok.encode(PROMPTS[0]), SamplingParams(
            max_tokens=12, top_k=1))
        ref.text()
        assert text == tok.decode(ref.token_ids) and len(text) > 10
        status, raw = _post(base + "/v1/score", {"text": CORPUS_SNIPPET,
                                                 "per_token": True})
        assert status == 200, raw
        out = json.loads(raw)
        assert out["tokens"] == len(want) + 1 and out["model"] == name
        assert out["mean_nll"] < 6.0
        np.testing.assert_allclose(out["nll"], want, rtol=0, atol=1e-5)
        assert abs(out["perplexity"] - np.exp(out["mean_nll"])) < 1e-2
        status, raw = _post(base + "/v1/score", {
            "tokens": tok.encode(CORPUS_SNIPPET), "chunk": 64})
        assert status == 200 and abs(json.loads(raw)["mean_nll"]
                                     - want.mean()) < 1e-5
        for body, code in (([1, 2], 400), ({}, 422), ({"tokens": [1]}, 422),
                           ({"text": CORPUS_SNIPPET, "chunk": 100}, 422),
                           ({"tokens": [1, 40000]}, 422),
                           ({"tokens": list(range(65))}, 413)):
            assert _post(base + "/v1/score", body)[0] == code, body
    engine.stop()


def test_int4_checkpoint_server_and_awq_refusal():
    """golden_tiny quantized to int4 (per channel) on load serves greedy
    tokens equal to the same quantized tree in a hand-built engine;
    int4_awq is refused, as for a registry config whose dims no group of
    32 or more divides (F = 176)."""
    from generativeaiexamples_tpu_torch.ops.quant import quantize_params
    engine, _ = build_services("golden-tiny", model_path=GOLDEN,
                               device="cpu", quantization="int4",
                               engine_cfg=EngineConfig(**ENGINE_KW,
                                                       kv_quant="int8"))
    assert set(engine.params["layers"]["w_down"]) == {"q4", "scale"}
    tok = engine.tokenizer
    sp = SamplingParams(max_tokens=10, top_k=1, ignore_eos=True)
    got = engine.generate_text(PROMPTS[1], sp)
    engine.stop()
    q4 = quantize_params(load_checkpoint(GOLDEN, CFG, dtype=torch.float32,
                                         device="cpu"), "int4")
    with _engine(q4, tok, kv_quant="int8") as eng:
        want = eng.generate_text(PROMPTS[1], sp)
    assert got == want and len(got) > 5
    with pytest.raises(ConfigError, match="int4_awq group"):
        build_services("golden-tiny", model_path=GOLDEN, device="cpu",
                       quantization="int4_awq",
                       engine_cfg=EngineConfig(**ENGINE_KW))


def test_cli_refuses_a_quantized_checkpoint(tmp_path, monkeypatch):
    """``python -m ...serving NAME --model-path DIR`` serves a GPTQ
    directory (golden-tiny's geometry, group 16, with its tokenizer and
    config.json): one greedy /v1/completions through the CLI's app equals
    the same engine's tokens, and its shutdown closes the engine. An
    act-order GPTQ directory is refused with ``ModelLoadError`` before
    anything is served; $MODEL_PATH is the flag's default."""
    import shutil

    from conftest import serve_app
    from torch_checkpoints import gptq_state, write_state
    from generativeaiexamples_tpu_torch.utils.errors import ModelLoadError
    good, bad = tmp_path / "gptq", tmp_path / "act_order"
    for d, act in ((good, False), (bad, True)):
        write_state(d, gptq_state(CFG, 16, act_order=act)[0], "safetensors")
        for f in ("tokenizer.model", "config.json"):
            shutil.copy(os.path.join(GOLDEN, f), d / f)
    seen = {}

    def run_app(app, host, port):
        import asyncio
        with serve_app(app) as base:
            status, raw = _post(base + "/v1/completions", {
                "prompt": PROMPTS[0], "max_tokens": 8, "temperature": 0})
            seen["status"], seen["out"] = status, json.loads(raw)
        seen["engine"] = engine_box[0]
        asyncio.run(app.cleanup())          # the server's shutdown

    engine_box = []
    real_build = model_server.build_services

    def build(*a, **k):
        out = real_build(*a, **k)
        engine_box.append(out[0])
        return out

    monkeypatch.setattr(model_server.web, "run_app", run_app)
    monkeypatch.setattr(model_server, "build_services", build)
    argv = ["golden-tiny", "--model-path", str(good), "--device", "cpu",
            "--dtype", "float32", "--no-embedder", "--max-batch-size", "2",
            "--max-input-length", "64", "--max-output-length", "16",
            "--kv-pool-tokens", "512", "--grpc-port", "0"]
    model_server.main(argv)
    assert seen["status"] == 200
    engine = seen["engine"]
    assert engine.params is None, "the CLI's shutdown did not close"
    assert model_server.last_load["format"] == "gptq"
    text = seen["out"]["choices"][0]["text"]
    # The same checkpoint in a fresh engine gives the same text.
    ref, _ = real_build("golden-tiny", model_path=str(good), device="cpu",
                        engine_cfg=EngineConfig(**ENGINE_KW))
    assert "gbias" in ref.params["layers"]["wq"]
    want = ref.generate_text(PROMPTS[0], SamplingParams(max_tokens=8,
                                                        top_k=1))
    ref.close()
    assert text == want and len(text) > 3
    with pytest.raises(ModelLoadError, match="act-order"):
        model_server.main(["golden-tiny", "--model-path", str(bad),
                           "--device", "cpu", "--dtype", "float32",
                           "--grpc-port", "0"])
    monkeypatch.setenv("MODEL_PATH", str(bad))
    with pytest.raises(ModelLoadError, match="act-order"):
        model_server.main(["golden-tiny", "--device", "cpu",
                           "--grpc-port", "0"])
