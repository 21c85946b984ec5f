"""Client library for the serving APIs, over ``urllib.request`` (a port of
the reference package's ``serving/client.py``, which uses ``requests``).

- ``TritonShimClient``: the Triton generate-extension dialect of
  ``serving/triton_shim.py`` (model-ready polling, single-shot and
  streaming generation with the ensemble's tensor names).
- ``OpenAIClient``: the ``/v1`` completions, chat and embeddings routes.
- ``JobsClient``: submit-then-poll over ``serving/jobs_api.py``.
- ``post_with_retry``: a JSON ``POST`` replayed with backoff only when the
  connection could not be made (``is_connect_failure``).
- The drain protocol's two calls (``POST /control/drain`` /
  ``/control/undrain`` on a chain-server replica, docs/router.md).

A status of 400 or more raises ``urllib.error.HTTPError``, as
``raise_for_status`` does in the reference.
"""

from __future__ import annotations

import json
import socket
import time
import urllib.error
import urllib.request
from typing import Iterator, Optional

from ..utils import faults
from ..utils.errors import FrameworkError
from ..utils.resilience import retry_call


class ServerNotReadyError(FrameworkError):
    pass


def is_connect_failure(exc: BaseException) -> bool:
    """True only when the failure happened ESTABLISHING the connection:
    the request cannot have run on the server, so a replay cannot run a
    generation twice. ``urlopen`` wraps what fails while connecting or
    sending in ``URLError`` (an ``HTTPError`` is an answer, not a
    failure); a reset or a timeout while reading the answer comes out
    raw, and the server may have done the work, so it is not replayed."""
    if isinstance(exc, urllib.error.HTTPError):
        return False
    if isinstance(exc, urllib.error.URLError):
        reason = exc.reason
        if isinstance(reason, BaseException):
            return is_connect_failure(reason) or isinstance(
                reason, (socket.gaierror, TimeoutError))
        return "refused" in str(reason).lower()
    if isinstance(exc, ConnectionRefusedError):
        return True
    # Builtin ConnectionError (injected faults too); its subclasses
    # Reset/Aborted/BrokenPipe mean bytes were already in flight.
    return type(exc) is ConnectionError


def _request(url: str, body=None, *, data: Optional[bytes] = None,
             headers: Optional[dict] = None,
             method: Optional[str] = None) -> urllib.request.Request:
    headers = dict(headers or {})
    if body is not None:
        data = json.dumps(body).encode()
        headers.setdefault("Content-Type", "application/json")
    elif data is None and method == "POST":
        data = b""
    return urllib.request.Request(url, data=data, headers=headers,
                                  method=method)


def post_with_retry(url: str, body=None, *, data: Optional[bytes] = None,
                    headers: Optional[dict] = None,
                    timeout: float = 120.0):
    """``POST`` a JSON ``body`` (or raw ``data``) and return the open
    response (a context manager; read it, or iterate it line by line for
    a stream). Retried with bounded exponential backoff (full jitter) on
    connect-phase failures only (``is_connect_failure``); the
    ``http.connect`` fault point fires per attempt, so chaos plans can
    drive the backoff path."""
    req = _request(url, body, data=data, headers=headers, method="POST")

    def _connect():
        faults.inject("http.connect")
        return urllib.request.urlopen(req, timeout=timeout)
    return retry_call(_connect, retry_on=(OSError,),
                      should_retry=is_connect_failure)


def _json(url: str, body=None, *, method: Optional[str] = None,
          timeout: float = 30.0):
    """(status, decoded JSON body) of one request."""
    req = _request(url, body, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


def get_json(url: str, timeout: float = 10.0) -> dict:
    """``GET`` a JSON body; an HTTP error status still yields its body
    (a drained replica's ``/health`` answers 503 with the count the
    drain poll reads)."""
    try:
        return _json(url, timeout=timeout)[1]
    except urllib.error.HTTPError as exc:
        return json.loads(exc.read() or b"{}")


def drain_replica(url: str, timeout: float = 10.0) -> dict:
    """Flip a chain-server replica to reject-new admission
    (``POST /control/drain``). Returns the server's ``{"status":
    "draining", "in_flight": N}``, so rollout tooling can poll
    ``/health`` until the in-flight count reaches 0 before it stops the
    process (``python -m generativeaiexamples_tpu_torch.router drain``).
    Raises ``urllib.error.URLError`` (``HTTPError`` on a non-2xx)."""
    return _json(f"{url.rstrip('/')}/control/drain", method="POST",
                 timeout=timeout)[1]


def undrain_replica(url: str, timeout: float = 10.0) -> dict:
    """Re-open admission on a drained replica (rollback)."""
    return _json(f"{url.rstrip('/')}/control/undrain", method="POST",
                 timeout=timeout)[1]


def iter_sse_data(resp) -> Iterator[str]:
    """The ``data:`` payloads of a server-sent-event response, as they
    arrive."""
    for raw in resp:
        line = raw.decode("utf-8").strip()
        if line.startswith("data:"):
            yield line[len("data:"):].strip()


class TritonShimClient:
    """HTTP client speaking the Triton generate-extension dialect."""

    def __init__(self, server_url: str, model_name: str = "ensemble",
                 timeout: float = 120.0):
        self.base = server_url.rstrip("/")
        self.model_name = model_name
        self.timeout = timeout

    def wait_ready(self, timeout: float = 60.0, interval: float = 0.5) -> None:
        """Poll the model's ready endpoint until it answers 2xx."""
        deadline = time.monotonic() + timeout
        url = f"{self.base}/v2/models/{self.model_name}/ready"
        last_err: Optional[str] = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(url, timeout=5):
                    return
            except urllib.error.HTTPError as exc:
                last_err = f"HTTP {exc.code}"
            except OSError as exc:
                last_err = str(exc)
            time.sleep(interval)
        raise ServerNotReadyError(
            f"model {self.model_name} not ready after {timeout}s: {last_err}")

    def _body(self, prompt: str, max_tokens: int, temperature: float,
              top_k: int, top_p: float, repetition_penalty: float,
              random_seed: int, stop_words: Optional[list[str]]) -> dict:
        # The ensemble's tensor names.
        return {"text_input": prompt, "max_tokens": max_tokens,
                "temperature": temperature, "top_k": top_k, "top_p": top_p,
                "repetition_penalty": repetition_penalty,
                "random_seed": random_seed, "beam_width": 1,
                "stop_words": stop_words or []}

    def generate(self, prompt: str, max_tokens: int = 100,
                 temperature: float = 1.0, top_k: int = 1,
                 top_p: float = 0.0, repetition_penalty: float = 1.0,
                 random_seed: int = 0,
                 stop_words: Optional[list[str]] = None) -> str:
        with post_with_retry(
                f"{self.base}/v2/models/{self.model_name}/generate",
                self._body(prompt, max_tokens, temperature, top_k, top_p,
                           repetition_penalty, random_seed, stop_words),
                timeout=self.timeout) as resp:
            return json.loads(resp.read())["text_output"]

    def generate_stream(self, prompt: str, max_tokens: int = 100,
                        temperature: float = 1.0, top_k: int = 1,
                        top_p: float = 0.0, repetition_penalty: float = 1.0,
                        random_seed: int = 0,
                        stop_words: Optional[list[str]] = None,
                        ) -> Iterator[str]:
        """Yield text deltas until the final-response flag."""
        with post_with_retry(
                f"{self.base}/v2/models/{self.model_name}/generate_stream",
                self._body(prompt, max_tokens, temperature, top_k, top_p,
                           repetition_penalty, random_seed, stop_words),
                timeout=self.timeout) as resp:
            for data in iter_sse_data(resp):
                payload = json.loads(data)
                if payload.get("text_output"):
                    yield payload["text_output"]
                if payload.get("triton_final_response"):
                    return


class OpenAIClient:
    """Thin client for the /v1 surface (completions + embeddings)."""

    def __init__(self, server_url: str, model: str = "default",
                 timeout: float = 120.0):
        self.base = server_url.rstrip("/")
        self.model = model
        self.timeout = timeout

    def _post(self, path: str, body: dict) -> dict:
        with post_with_retry(f"{self.base}{path}", body,
                             timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def complete(self, prompt: str, **kw) -> str:
        out = self._post("/v1/completions",
                         {"model": self.model, "prompt": prompt, **kw})
        return out["choices"][0]["text"]

    def chat(self, messages: list[dict], **kw) -> str:
        out = self._post("/v1/chat/completions",
                         {"model": self.model, "messages": messages, **kw})
        return out["choices"][0]["message"]["content"]

    def embed(self, texts: list[str], input_type: str = "query"
              ) -> list[list[float]]:
        out = self._post("/v1/embeddings",
                         {"input": texts, "input_type": input_type})
        return [d["embedding"] for d in out["data"]]


class JobsClient:
    """Submit-then-poll client for the async job API: ``POST /v1/jobs``,
    then re-``GET`` the job while it answers 202."""

    def __init__(self, server_url: str, timeout: float = 300.0,
                 poll_interval: float = 0.25):
        self.base = server_url.rstrip("/")
        self.timeout = timeout
        self.poll_interval = poll_interval

    def submit(self, prompt: str, **sampling) -> dict:
        """The job's snapshot: ``status`` "done" (200) when it finished
        within the server's grace period, else "running" (202)."""
        return _json(f"{self.base}/v1/jobs",
                     {"prompt": prompt, **sampling})[1]

    def wait(self, job_id: str) -> dict:
        deadline = time.monotonic() + self.timeout
        while True:
            status, snap = _json(f"{self.base}/v1/jobs/{job_id}")
            if status == 200:
                return snap
            if status != 202:
                raise urllib.error.HTTPError(
                    f"{self.base}/v1/jobs/{job_id}", status,
                    f"unexpected status {status}", None, None)
            if time.monotonic() > deadline:
                raise TimeoutError(f"job {job_id} still running after "
                                   f"{self.timeout}s")
            time.sleep(self.poll_interval)

    def generate(self, prompt: str, **sampling) -> str:
        job = self.submit(prompt, **sampling)
        if job["status"] == "done":
            return job["text"]
        return self.wait(job["id"])["text"]

    def cancel(self, job_id: str) -> None:
        """Cancel and forget a job (an unknown id is not an error)."""
        try:
            _json(f"{self.base}/v1/jobs/{job_id}", method="DELETE")
        except urllib.error.HTTPError:
            pass

    def available_models(self) -> dict:
        """{model name: entry} from the server's model registry."""
        body = _json(f"{self.base}/v1/models")[1]
        return {e["id"]: e for e in body.get("data", [])}

    def resolve_model(self, name: str) -> str:
        """Exact-then-substring model-name resolution: 'llama' finds
        'llama-2-7b-chat'. Raises on no match."""
        models = self.available_models()
        if name in models:
            return name
        for key in sorted(models):
            if name in key:
                return key
        raise ValueError(f"unknown model name {name!r}; server has "
                         f"{sorted(models)}")
