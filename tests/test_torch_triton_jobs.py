"""The port's Triton-shim and job routes against the reference package's:
the port's model server over the port's engine and the reference's over
the JAX ``Engine``, both on ``llama-tiny`` (float32, CPU) with the same
numpy parameters carried across by ``params_from_numpy``. Each package's
``TritonShimClient`` and ``JobsClient`` runs against both servers.

Tolerances: greedy texts, statuses and snapshot fields exact;
``SamplingParams`` equal field by field."""

import asyncio
import contextlib
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.serving import client as tclient
from generativeaiexamples_tpu_torch.serving import jobs_api, triton_shim
from generativeaiexamples_tpu_torch.serving.model_server import \
    create_server_app
from generativeaiexamples_tpu_torch.serving.openai_api import \
    _sampling_from_body

from generativeaiexamples_tpu.serving import client as jclient
from generativeaiexamples_tpu.serving import jobs_api as jjobs_api
from generativeaiexamples_tpu.serving import triton_shim as jtriton_shim
from generativeaiexamples_tpu.serving.openai_api import \
    _sampling_from_body as jsampling_from_body

ENGINE_KW = dict(max_slots=4, max_input_length=64, max_output_length=32,
                 prefill_buckets=(16, 32, 64), dtype="float32", max_queue=64,
                 page_size=16)
PROMPT = "the quick brown fox"
NEW = 16
TIMEOUT = 60


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


def _call(url, body=None, method=None):
    """(status, decoded JSON or text body) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        status, text = exc.code, exc.read().decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


@contextlib.contextmanager
def _held(engine):
    """The engine's serve loop stopped and kept so (requests queue and
    wait) until the block ends."""
    engine.stop()
    engine.start = lambda: None
    try:
        yield
    finally:
        del engine.start
        engine.start()


@pytest.fixture(scope="module")
def servers():
    """Both model servers (and a jobs-only app with no grace period per
    package) over engines on the same llama-tiny parameters."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu.serving.model_server import \
        create_server_app as jcreate

    jparams = jllama.init_params(JCFG, jax.random.key(11), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                               torch.float32, cfg=LLAMA_TINY)
    eng = Engine(params, LLAMA_TINY, ByteTokenizer(),
                 EngineConfig(**ENGINE_KW), device="cpu")
    jeng = JEngine(jparams, JCFG, JTok(), JConfig(**ENGINE_KW))
    jobs_now, jjobs_now = web.Application(), web.Application()
    jobs_api.add_jobs_routes(jobs_now, eng, "llama-tiny", sync_wait=0.0)
    jjobs_api.add_jobs_routes(jjobs_now, jeng, "llama-tiny", sync_wait=0.0)
    with _serve(create_server_app(eng, None, "llama-tiny")) as port, \
            _serve(jcreate(jeng, None, "llama-tiny")) as ref, \
            _serve(jobs_now) as port_jobs, _serve(jjobs_now) as ref_jobs:
        yield {"port": port, "ref": ref, "port_jobs": port_jobs,
               "ref_jobs": ref_jobs, "engines": {"port": eng, "ref": jeng}}
    eng.stop()
    jeng.stop()


@pytest.fixture(scope="module")
def greedy(servers):
    """The reference's greedy text for PROMPT through its own
    ``/v1/completions`` (temperature 0)."""
    status, body = _call(servers["ref"] + "/v1/completions", {
        "prompt": PROMPT, "max_tokens": NEW, "temperature": 0})
    assert status == 200
    text = body["choices"][0]["text"]
    assert len(text) > 3
    return text


CLIENTS = {"port": tclient, "ref": jclient}
PAIRS = [(c, s) for c in ("port", "ref") for s in ("port", "ref")]


@pytest.mark.parametrize("client,server", PAIRS)
@pytest.mark.parametrize("stream", [False, True], ids=["generate", "stream"])
def test_triton_generate_gives_the_reference_greedy_text(servers, greedy,
                                                         client, server,
                                                         stream):
    c = CLIENTS[client].TritonShimClient(servers[server],
                                         model_name="llama-tiny")
    c.wait_ready(timeout=10)
    if stream:
        chunks = list(c.generate_stream(PROMPT, max_tokens=NEW))
        assert len(chunks) > 1
        text = "".join(chunks)
    else:
        text = c.generate(PROMPT, max_tokens=NEW)
    assert text == greedy


def test_triton_bare_body_is_greedy(servers, greedy):
    """Without sampling fields the shim is greedy (top_k 1, temperature
    1.0), on both servers; the ``ensemble`` alias serves the same model;
    the ready endpoints and the model index answer alike."""
    for side in ("port", "ref"):
        base = servers[side]
        for model in ("llama-tiny", "ensemble"):
            status, body = _call(f"{base}/v2/models/{model}/generate",
                                 {"text_input": [[PROMPT]],
                                  "max_tokens": [NEW]})
            assert status == 200 and body == {"model_name": model,
                                              "text_output": greedy}
        assert _call(base + "/v2/health/ready") == (200, {"ready": True})
        assert _call(base + "/v2/health/live") == (200, {"ready": True})
        assert _call(base + "/v2/repository/index", {}) == (200, [
            {"name": "ensemble", "state": "READY"},
            {"name": "llama-tiny", "state": "READY"}])
    out = {side: [_call(servers[side] + path, body)[0] for path, body in (
        ("/v2/models/other/ready", None),
        ("/v2/models/other/generate", {"text_input": "x"}),
        ("/v2/models/llama-tiny/generate", {"max_tokens": 4}),
        ("/v2/models/llama-tiny/generate", {"text_input": "x",
                                            "beam_width": 2}),
        ("/v2/models/llama-tiny/generate_stream",
         {"text_input": "x", "length_penalty": 2.0}),
        ("/v2/models/llama-tiny/generate", {"text_input": "x" * 200}))]
        for side in ("port", "ref")}
    assert out["port"] == out["ref"] == [404, 404, 400, 400, 400, 400]
    with pytest.raises(tclient.ServerNotReadyError, match="not ready"):
        tclient.TritonShimClient(servers["port"], "other").wait_ready(
            timeout=0.3, interval=0.1)


def test_triton_stream_frames_match_the_reference(servers):
    """The SSE frames of generate_stream: deltas with
    ``triton_final_response`` false, then one final frame with the finish
    reason."""
    frames = {}
    for side in ("port", "ref"):
        req = urllib.request.Request(
            servers[side] + "/v2/models/llama-tiny/generate_stream",
            data=json.dumps({"text_input": PROMPT,
                             "max_tokens": NEW}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            frames[side] = [json.loads(d) for d in tclient.iter_sse_data(resp)]
    assert frames["port"] == frames["ref"]
    assert frames["port"][-1]["triton_final_response"] is True
    assert frames["port"][-1]["finish_reason"] in ("length", "eos")
    assert not any(f["triton_final_response"] for f in frames["port"][:-1])


def test_triton_client_disconnect_cancels_the_request(servers, monkeypatch):
    """A client that goes away mid-stream frees its slot: the stream
    finishes "cancelled" with fewer tokens than asked for."""
    eng = servers["engines"]["port"]
    streams = []
    orig = eng.stream_text

    def keep(*a, **kw):
        streams.append(orig(*a, **kw))
        return streams[-1]
    monkeypatch.setattr(eng, "stream_text", keep)
    with _held(eng):
        req = urllib.request.Request(
            servers["port"] + "/v2/models/llama-tiny/generate_stream",
            data=json.dumps({"text_input": PROMPT,
                             "max_tokens": 32}).encode(),
            headers={"Content-Type": "application/json"})
        resp = urllib.request.urlopen(req, timeout=TIMEOUT)
        resp.close()
        time.sleep(0.3)   # the server sees the connection close
    s = streams[-1]
    deadline = time.monotonic() + TIMEOUT
    while s.finish_reason is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert s.cancelled and s.finish_reason == "cancelled"
    assert len(s.token_ids) < 32
    while eng.stats["active_slots"] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng.stats["active_slots"] == 0


# -------------------------------------------------------------------- jobs

@pytest.mark.parametrize("client,server", PAIRS)
def test_jobs_generate_gives_the_reference_greedy_text(servers, greedy,
                                                       client, server):
    c = CLIENTS[client].JobsClient(servers[server], poll_interval=0.02)
    job = c.submit(PROMPT, max_tokens=NEW, temperature=0)
    assert job["status"] in ("done", "running")
    assert c.generate(PROMPT, max_tokens=NEW, temperature=0) == greedy
    assert c.resolve_model("tiny") == "llama-tiny"
    with pytest.raises(ValueError, match="unknown model"):
        c.resolve_model("mistral")


@pytest.mark.parametrize("client,server", PAIRS)
def test_jobs_202_then_poll(servers, greedy, client, server):
    """A job that has not finished answers 202 "running" at submit and at
    each poll; once the engine runs it, the poll answers 200 with the
    greedy text."""
    base = servers[server + "_jobs"]
    c = CLIENTS[client].JobsClient(base, poll_interval=0.02)
    with _held(servers["engines"][server]):
        job = c.submit(PROMPT, max_tokens=NEW, temperature=0)
        assert job["status"] == "running" and job["text"] == ""
        assert _call(f"{base}/v1/jobs/{job['id']}")[0] == 202
    done = c.wait(job["id"])
    assert (done["status"], done["text"], done["error"]) == (
        "done", greedy, None)
    assert done["finish_reason"] in ("length", "eos")


def test_jobs_errors_cancel_cap_and_reaper_match_the_reference(servers,
                                                               monkeypatch):
    statuses = {}
    for side, mod in (("port", jobs_api), ("ref", jjobs_api)):
        base = servers[side + "_jobs"]
        eng = servers["engines"][side]
        out = [_call(base + "/v1/jobs", body)[0] for body in (
            {"prompt": ""}, {"prompt": "x", "model": "other"},
            {"prompt": "x", "max_tokens": 0},
            {"prompt": "x" * 200}, {"prompt": "x", "temperature": "hot"})]
        out.append(_call(base + "/v1/jobs/job-none")[0])
        # Finished jobs are reaped at once: each submit clears the table
        # of the earlier tests' jobs.
        monkeypatch.setattr(mod, "_TTL_SEC", 0.0)
        with _held(eng):
            status, job = _call(base + "/v1/jobs", {"prompt": PROMPT,
                                                    "max_tokens": 8})
            out.append(status)
            # Cancel forgets the job.
            out.append(_call(f"{base}/v1/jobs/{job['id']}",
                             method="DELETE"))
            out.append(_call(f"{base}/v1/jobs/{job['id']}")[0])
            # The table's cap.
            monkeypatch.setattr(mod, "_MAX_JOBS", 1)
            status, held = _call(base + "/v1/jobs", {"prompt": PROMPT,
                                                     "max_tokens": 4})
            out += [status, _call(base + "/v1/jobs", {"prompt": "y"})[0]]
        CLIENTS[side].JobsClient(base, poll_interval=0.02).wait(held["id"])
        # A finished job past its TTL is reaped by the next submit.
        monkeypatch.setattr(mod, "_MAX_JOBS", 256)
        status, last = _call(base + "/v1/jobs", {"prompt": PROMPT,
                                                 "max_tokens": 4})
        out.append(_call(f"{base}/v1/jobs/{held['id']}")[0])
        CLIENTS[side].JobsClient(base, poll_interval=0.02).wait(last["id"])
        monkeypatch.undo()
        statuses[side] = [o[:1] + (o[1]["status"],) if isinstance(o, tuple)
                          else o for o in out]
    assert statuses["port"] == statuses["ref"] == [
        422, 404, 400, 400, 400, 404, 202, (200, "cancelled"), 404,
        202, 429, 404]


# ------------------------------------------------------ parameter parsing

_SCALAR = {"max_tokens": st.integers(-2, 600),
           "temperature": st.floats(-1, 3, allow_nan=False),
           "top_k": st.integers(-1, 50),
           "top_p": st.floats(-0.5, 1.5, allow_nan=False),
           "repetition_penalty": st.floats(0, 3, allow_nan=False),
           "length_penalty": st.sampled_from([1.0, 1, 0.5]),
           "random_seed": st.integers(0, 2 ** 31),
           "beam_width": st.sampled_from([1, 1, 1, 2])}
_WORDS = st.one_of(st.text(max_size=4),
                   st.lists(st.text(max_size=4), max_size=3))


def _wrapped(value):
    return st.sampled_from([value, [value], [[value]]])


_TRITON_BODY = st.fixed_dictionaries({}, optional={
    **{k: v.flatmap(_wrapped) for k, v in _SCALAR.items()},
    "stop_words": _WORDS, "bad_words": _WORDS})


def _outcome(fn, *args):
    """The parsed params as a dict, or the kind of error."""
    try:
        return dataclasses.asdict(fn(*args))
    except web.HTTPBadRequest:
        return "400"
    except (ValueError, TypeError):
        return "invalid"


@settings(max_examples=150, deadline=None)
@given(body=_TRITON_BODY, max_output=st.integers(1, 512))
def test_params_from_triton_match_the_reference(body, max_output):
    assert _outcome(triton_shim._params_from_triton, body, max_output) == \
        _outcome(jtriton_shim._params_from_triton, body, max_output)


_JOBS_BODY = st.fixed_dictionaries({}, optional={
    **{k: _SCALAR[k] for k in ("max_tokens", "temperature", "top_k",
                                "top_p", "repetition_penalty")},
    "seed": st.integers(0, 100), "random_seed": st.integers(0, 100),
    "stop": _WORDS})


@settings(max_examples=150, deadline=None)
@given(body=_JOBS_BODY, max_output=st.integers(1, 512))
def test_jobs_body_params_match_the_reference(body, max_output):
    assert _outcome(_sampling_from_body, body, max_output) == \
        _outcome(jsampling_from_body, body, max_output)


# ------------------------------------------------------- AzureML resolver

def test_azureml_model_dir_resolves_as_the_reference(tmp_path, monkeypatch):
    from generativeaiexamples_tpu_torch.serving.model_server import \
        resolve_azureml_model_dir
    from generativeaiexamples_tpu_torch.utils.errors import ConfigError

    from generativeaiexamples_tpu.serving.model_server import \
        resolve_azureml_model_dir as jresolve
    from generativeaiexamples_tpu.utils.errors import \
        ConfigError as JConfigError

    aml = tmp_path / "aml"
    aml.mkdir()
    (aml / "MLmodel").write_text("flavor")
    (aml / ".hidden").mkdir()
    (aml / "zeta").mkdir()
    (aml / "llama").mkdir()
    monkeypatch.delenv("AZUREML_MODEL_DIR", raising=False)
    assert resolve_azureml_model_dir("") == jresolve("") == ""
    monkeypatch.setenv("AZUREML_MODEL_DIR", str(aml))
    for path in ("", "/explicit/dir"):
        assert resolve_azureml_model_dir(path) == jresolve(path)
    assert resolve_azureml_model_dir("") == str(aml / "llama")
    for empty in (tmp_path / "empty", tmp_path / "missing"):
        if empty.name == "empty":
            empty.mkdir()
        monkeypatch.setenv("AZUREML_MODEL_DIR", str(empty))
        with pytest.raises(ConfigError, match="AzureML"):
            resolve_azureml_model_dir("")
        with pytest.raises(JConfigError, match="AzureML"):
            jresolve("")


def test_build_services_loads_the_azureml_model_dir(tmp_path, monkeypatch):
    """With no model path, ``build_services`` serves the checkpoint under
    ``$AZUREML_MODEL_DIR`` (golden-tiny here)."""
    import os
    from generativeaiexamples_tpu_torch.serving import model_server
    aml = tmp_path / "aml"
    aml.mkdir()
    os.symlink(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "golden_tiny"), aml / "golden")
    monkeypatch.setenv("AZUREML_MODEL_DIR", str(aml))
    monkeypatch.setenv("GAIE_WEIGHT_CACHE", "0")
    eng, name = model_server.build_services(
        "golden-tiny", device="cpu",
        engine_cfg=EngineConfig(**ENGINE_KW))
    assert name == "golden-tiny"
    assert model_server.last_load["format"] == "safetensors"
    assert eng.tokenizer.vocab_size == 32000
    eng.close()
