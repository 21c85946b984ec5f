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
    engine.stop()


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
