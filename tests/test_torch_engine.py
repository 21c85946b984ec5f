"""The port's engine and HTTP surface on the CPU, against the JAX engine.

Greedy decoding is deterministic, so with the same numpy parameters
(``llama-tiny`` geometry, float32) and the same prompts both engines must
emit identical tokens, whatever their batching and scheduling."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.serving.model_server import (
    build_services, create_server_app)
from generativeaiexamples_tpu_torch.utils.errors import (ConfigError,
                                                         EngineError)

CFG = LLAMA_TINY
ENGINE_KW = dict(max_slots=4, max_input_length=64, max_output_length=32,
                 prefill_buckets=(16, 32, 64), dtype="float32", max_queue=64,
                 page_size=16)
PROMPTS = ["hello", "a somewhat longer prompt that spans pages",
           "x", "0123456789abcdefghij", "the quick brown fox"]


@pytest.fixture(scope="module")
def jax_params():
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    return jllama.init_params(JCFG, jax.random.key(11), dtype=jnp.float32)


@pytest.fixture(scope="module")
def engine(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    params = params_from_numpy(tree, "cpu", torch.float32, cfg=CFG)
    eng = Engine(params, CFG, ByteTokenizer(), EngineConfig(**ENGINE_KW),
                 device="cpu")
    with eng:
        yield eng


@pytest.fixture(scope="module")
def quant_engine(jax_params):
    """int4_awq weights (group 32: LLAMA_TINY's F = 352 is not a multiple
    of 128) over an int8 KV pool, from the same numpy parameters as the
    JAX side."""
    from generativeaiexamples_tpu.ops.quant import quantize_params
    jqp = quantize_params(jax_params, "int4_awq", 32)
    params = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu",
                               torch.float32, cfg=CFG)
    eng = Engine(params, CFG, ByteTokenizer(),
                 EngineConfig(**ENGINE_KW, kv_quant="int8"), device="cpu")
    with eng:
        yield eng, jqp


def _greedy(n):
    return SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)


def test_greedy_tokens_match_jax_engine(engine, jax_params):
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok

    lens = [12, 7, 20, 3, 9]
    tok = engine.tokenizer
    streams = [engine.submit(tok.encode(p), _greedy(n))
               for p, n in zip(PROMPTS, lens)]
    ours = [(s.text(), s.token_ids, s.finish_reason) for s in streams]
    with JEngine(jax_params, JCFG, JTok(), JConfig(**ENGINE_KW)) as jeng:
        jstreams = [jeng.submit(tok.encode(p),
                                JParams(max_tokens=n, top_k=1,
                                        ignore_eos=True))
                    for p, n in zip(PROMPTS, lens)]
        theirs = [(s.text(), s.token_ids, s.finish_reason) for s in jstreams]
    assert [o[1] for o in ours] == [t[1] for t in theirs]
    assert ours == theirs
    assert all(len(o[1]) == n for o, n in zip(ours, lens))


def test_quantized_greedy_tokens_match_jax_engine(quant_engine):
    """kv_quant="int8" plus int4_awq weights: the port's greedy tokens
    equal the JAX engine's on the same quantized parameters (the JAX
    prefix cache is off: under int8 KV a reused prefix is read back
    dequantized, which the port does not model)."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok

    engine, jqp = quant_engine
    assert engine._state["cache"]["k"].dtype == torch.int8
    lens = [12, 7, 20, 3, 9]
    tok = engine.tokenizer
    streams = [engine.submit(tok.encode(p), _greedy(n))
               for p, n in zip(PROMPTS, lens)]
    ours = [(s.text(), s.token_ids, s.finish_reason) for s in streams]
    jcfg = JConfig(**ENGINE_KW, kv_quant="int8", prefix_cache=False)
    with JEngine(jqp, JCFG, JTok(), jcfg) as jeng:
        jstreams = [jeng.submit(tok.encode(p),
                                JParams(max_tokens=n, top_k=1,
                                        ignore_eos=True))
                    for p, n in zip(PROMPTS, lens)]
        theirs = [(s.text(), s.token_ids, s.finish_reason) for s in jstreams]
    assert [o[1] for o in ours] == [t[1] for t in theirs]
    assert ours == theirs


def test_kv_quant_config_and_pool_bytes(quant_engine):
    """int8 pools count L*KV*2*(hd + 2) bytes a token (rows plus one bf16
    scale each); the prefill reserve keeps the dense compute-dtype bytes."""
    engine, _ = quant_engine
    m = CFG
    assert engine._kv_bytes_per_token() == (
        m.num_layers * m.num_kv_heads * 2 * (m.head_dim + 2))
    assert engine._kv_bytes_per_token(pooled=False) == (
        2 * m.num_layers * m.num_kv_heads * m.head_dim * 4)
    cache = engine._state["cache"]
    assert cache["ks"].dtype == torch.bfloat16
    assert cache["ks"].shape == cache["k"].shape[:4]
    with pytest.raises(ConfigError, match="kv_quant"):
        EngineConfig(kv_quant="int4")


def test_more_requests_than_slots_all_finish(engine):
    streams = [engine.submit(engine.tokenizer.encode(f"req {i}"),
                             _greedy(3 + i % 4)) for i in range(9)]
    for i, s in enumerate(streams):
        s.text()
        assert s.finish_reason == "length"
        assert len(s.token_ids) == 3 + i % 4
    # Finished streams hand their slots back at the serve loop's next
    # iteration.
    deadline = time.monotonic() + 10
    while engine.stats["active_slots"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine.stats["active_slots"] == 0
    assert engine.stats["free_pages"] == engine.stats["pool_pages"]


def _printable(token_ids):
    """The first generated token that is one printable ASCII byte of the
    byte tokenizer (ids 3..258 are bytes 0..255)."""
    picks = [t for t in token_ids if 3 + 32 <= t < 3 + 127]
    assert picks, f"no printable byte among {token_ids}"
    return picks[0], chr(picks[0] - 3)


def test_stop_word_and_streaming(engine):
    ids = engine.tokenizer.encode("hello")
    full = engine.submit(ids, _greedy(10))
    text = full.text()
    chunks = list(engine.submit(ids, _greedy(10)))
    assert "".join(chunks) == text
    _, stop = _printable(full.token_ids)
    s = engine.submit(ids, SamplingParams(max_tokens=10, top_k=1,
                                          ignore_eos=True,
                                          stop_words=[stop]))
    assert s.text() == text[:text.find(stop)]
    assert s.finish_reason == "stop"


def test_bad_words_are_never_generated(engine):
    ids = engine.tokenizer.encode("hello")
    base = engine.submit(ids, _greedy(8))
    base.text()
    tok, word = _printable(base.token_ids)
    s = engine.submit(ids, SamplingParams(max_tokens=8, top_k=1,
                                          ignore_eos=True,
                                          bad_words=[word]))
    s.text()
    assert len(s.token_ids) == 8 and tok not in s.token_ids


def test_bad_sequence_match():
    """A sequence of length l bans its last token once the l-1 most
    recent generated tokens equal its prefix (the reference's
    ``bad_seq_hits``)."""
    seq = torch.full((2, 2, 4), -1, dtype=torch.int32)
    seq[0, 0, :3] = torch.tensor([5, 6, 7])
    seq[0, 1, :2] = torch.tensor([9, 4])
    seq[1, 0, :3] = torch.tensor([5, 6, 7])
    blen = torch.tensor([[3, 2], [3, 0]], dtype=torch.int32)
    recent = torch.tensor([[1, 5, 6], [5, 6, 8]], dtype=torch.int32)
    hit, tail = Engine._bad_seq_hits(seq, blen, recent)
    assert hit.tolist() == [[True, False], [False, False]]
    assert tail[0].tolist() == [7, 4]


def test_sampled_requests_finish(engine):
    s = engine.submit(engine.tokenizer.encode("sample me"),
                      SamplingParams(max_tokens=6, temperature=0.8,
                                     top_k=20, top_p=0.9,
                                     repetition_penalty=1.2,
                                     ignore_eos=True, random_seed=5))
    s.text()
    assert len(s.token_ids) == 6
    assert all(0 <= t < CFG.vocab_size for t in s.token_ids)


def test_submit_validation(engine):
    with pytest.raises(EngineError):
        engine.submit([], _greedy(2))
    with pytest.raises(EngineError):
        engine.submit([5] * 65, _greedy(2))


def test_cuda_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ConfigError, match="no CUDA device"):
        build_services("llama-tiny")


def test_completions_round_trip():
    from conftest import serve_app

    engine, name = build_services(
        "llama-tiny", engine_cfg=EngineConfig(**ENGINE_KW), seed=1,
        device="cpu")
    app = create_server_app(engine, name)
    with serve_app(app) as base:
        def post(body):
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read().decode()

        body = {"prompt": "hello there", "max_tokens": 6,
                "temperature": 0}
        out = json.loads(post(body))
        choice = out["choices"][0]
        assert out["object"] == "text_completion" and out["model"] == name
        assert choice["finish_reason"] in ("length", "eos", "stop")
        assert out["usage"]["completion_tokens"] <= 6
        sse = post({**body, "stream": True})
        events = [ln[len("data: "):] for ln in sse.splitlines()
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        deltas = [json.loads(e)["choices"][0] for e in events[:-1]]
        assert "".join(d["text"] for d in deltas) == choice["text"]
        assert deltas[-1]["finish_reason"] == choice["finish_reason"]
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok"
        assert health["engine"]["requests"] == 2
        assert health["quantization"] == "" and health["kv_quant"] == ""
    engine.stop()


def test_completions_round_trip_int4_awq_int8_pool():
    """/v1/completions through ``build_services(quantization="int4_awq")``
    over an int8 pool (JSON and SSE), and /health reports both modes."""
    from conftest import serve_app

    engine, name = build_services(
        "llama-tiny", engine_cfg=EngineConfig(**ENGINE_KW, kv_quant="int8"),
        seed=1, device="cpu", quantization="int4_awq")
    # LLAMA_TINY's F = 352 takes the largest group dividing it: 32.
    w_down = engine.params["layers"]["w_down"]
    assert set(w_down) == {"q4", "gscale"}
    assert w_down["gscale"].shape == (CFG.num_layers, 352 // 32, 128)
    with serve_app(create_server_app(engine, name)) as base:
        def post(body):
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read().decode()

        body = {"prompt": "quantized hello", "max_tokens": 5,
                "temperature": 0}
        out = json.loads(post(body))
        choice = out["choices"][0]
        assert out["usage"]["completion_tokens"] <= 5
        events = [ln[len("data: "):]
                  for ln in post({**body, "stream": True}).splitlines()
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        assert "".join(json.loads(e)["choices"][0]["text"]
                       for e in events[:-1]) == choice["text"]
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["quantization"] == "int4_awq"
        assert health["kv_quant"] == "int8"
    engine.stop()
    with pytest.raises(ValueError, match="quantization"):
        build_services("llama-tiny", device="cpu", quantization="fp4")


def test_port_imports_no_jax():
    """Every module of the port imports, and neither jax nor the JAX
    package ends up loaded."""
    code = r"""
import importlib, pkgutil, sys
import generativeaiexamples_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "generativeaiexamples_tpu"
             or m.startswith("generativeaiexamples_tpu."))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("quant", [[], ["--quantization", "int4_awq",
                                        "--kv-quant", "int8"]],
                         ids=["bf16", "int4_awq-int8kv"])
def test_profile_prefill_mode_on_cpu(quant, capsys):
    """``tools/profile_decode --prefill`` drives one full-bucket prefill
    per measurement and reports it (on the CPU: no device time, no kernel
    launch); a bucket the engine does not have is refused."""
    from generativeaiexamples_tpu_torch.tools import profile_decode
    assert profile_decode.main(["--model", "llama-tiny", "--device", "cpu",
                                "--prefill", "128", "--rounds", "1",
                                *quant]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["prefill_bucket"] == 128 and out["card"] == "cpu"
    assert out["prefill_ms"] > 0 and out["device_ms"] == 0
    assert out["int4_launches_by_path"] == {"tc": 0, "gemv": 0, "tile": 0,
                                            "wg": 0}
    with pytest.raises(SystemExit, match="not a prefill bucket"):
        profile_decode.main(["--model", "llama-tiny", "--device", "cpu",
                             "--prefill", "100"])
