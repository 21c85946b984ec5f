"""LangChain connector classes for the port's serving stack (a port of the
reference package's ``integrations/langchain_tpu.py``; the classes are
named ``Torch*`` here).

``TorchLLM`` / ``TorchEmbeddings`` play the roles of a Triton LLM
connector and an embeddings class against the port's endpoints:

- ``mode="grpc"``  — the native LLMService (serving/grpc_server.py, the
  model server's ``--grpc-port``, default 8001);
- ``mode="http"``  — the OpenAI-compatible ``/v1`` API
  (serving/openai_api.py).

``TorchJobsLLM`` goes through the job API (serving/jobs_api.py). When
langchain-core is installed the classes are real LangChain components
(they work in LCEL chains); otherwise they derive from minimal structural
stand-ins with the same contract, so the connector logic works and tests
run without the dependency.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional

try:  # real LangChain base classes when available
    from langchain_core.callbacks import CallbackManagerForLLMRun
    from langchain_core.embeddings import Embeddings as _LCEmbeddings
    from langchain_core.language_models.llms import LLM as _LCLLM
    from langchain_core.outputs import GenerationChunk
    HAVE_LANGCHAIN = True
except ImportError:  # structural stand-ins (same method contracts)
    HAVE_LANGCHAIN = False
    CallbackManagerForLLMRun = Any  # type: ignore[assignment,misc]

    class GenerationChunk:  # type: ignore[no-redef]
        def __init__(self, text: str):
            self.text = text

    class _LCLLM:  # type: ignore[no-redef]
        """Contract subset of langchain_core LLM: invoke/stream drive
        _call/_stream. Pydantic field declaration degrades to kwargs."""

        def __init__(self, **kwargs: Any):
            for k, v in kwargs.items():
                setattr(self, k, v)

        def invoke(self, prompt: str, stop: Optional[List[str]] = None,
                   **kw: Any) -> str:
            return self._call(prompt, stop=stop, **kw)

        def stream(self, prompt: str, stop: Optional[List[str]] = None,
                   **kw: Any) -> Iterator[str]:
            for chunk in self._stream(prompt, stop=stop, **kw):
                yield chunk.text

    class _LCEmbeddings:  # type: ignore[no-redef]
        def __init__(self, **kwargs: Any):
            for k, v in kwargs.items():
                setattr(self, k, v)


STOP_WORDS = ["</s>"]  # reference connector default, triton_trt_llm.py:45


class TorchLLM(_LCLLM):
    """LangChain LLM over the port's serving stack.

    Parameters mirror the reference connector's
    (triton_trt_llm.py:66-79): server_url, model_name, temperature,
    top_p, top_k, tokens, beam_width, repetition_penalty, length_penalty,
    streaming.
    """

    server_url: str = ""
    model_name: str = "ensemble"
    mode: str = "grpc"               # "grpc" | "http"
    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 1
    tokens: int = 100
    beam_width: int = 1
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    streaming: bool = True
    timeout: float = 120.0

    # pydantic v2 (real langchain) allows arbitrary private attrs via
    # model_config; the stand-in just sets attributes.
    model_config = {"arbitrary_types_allowed": True, "extra": "allow"}

    @property
    def _llm_type(self) -> str:
        return "torch_llm"

    @property
    def _identifying_params(self) -> dict:
        return {"server_url": self.server_url, "model_name": self.model_name,
                "mode": self.mode}

    @property
    def _default_params(self) -> dict:
        return {"max_tokens": self.tokens, "temperature": self.temperature,
                "top_k": self.top_k, "top_p": self.top_p,
                "repetition_penalty": self.repetition_penalty,
                "length_penalty": self.length_penalty,
                "beam_width": self.beam_width}

    def _grpc(self):
        client = getattr(self, "_grpc_client", None)
        if client is None:
            from ..serving.grpc_server import GrpcLLMClient
            client = GrpcLLMClient(self.server_url, timeout=self.timeout)
            object.__setattr__(self, "_grpc_client", client)
        return client

    def _http(self):
        client = getattr(self, "_http_client", None)
        if client is None:
            from ..chains.llm import OpenAICompatLLM
            client = OpenAICompatLLM(self.server_url, self.model_name,
                                     timeout=self.timeout)
            object.__setattr__(self, "_http_client", client)
        return client

    def _merged(self, stop: Optional[List[str]], kwargs: dict) -> dict:
        params = {**self._default_params, **kwargs}
        params["stop_words"] = list(stop if stop is not None else STOP_WORDS)
        return params

    def _call(self, prompt: str, stop: Optional[List[str]] = None,
              run_manager: Optional[CallbackManagerForLLMRun] = None,
              **kwargs: Any) -> str:
        return "".join(c.text for c in
                       self._stream(prompt, stop=stop, **kwargs))

    def _stream(self, prompt: str, stop: Optional[List[str]] = None,
                run_manager: Optional[CallbackManagerForLLMRun] = None,
                **kwargs: Any) -> Iterator[GenerationChunk]:
        p = self._merged(stop, kwargs)
        if self.mode == "grpc":
            it = self._grpc().generate_stream(
                prompt, max_tokens=p["max_tokens"],
                temperature=p["temperature"], top_k=p["top_k"],
                top_p=p["top_p"],
                repetition_penalty=p["repetition_penalty"],
                length_penalty=p["length_penalty"],
                beam_width=p["beam_width"], stop_words=p["stop_words"],
                bad_words=list(p.get("bad_words", [])))
        else:
            # The OpenAI-compatible surface carries no penalty/ban
            # fields; silently differing from mode="grpc" would be worse
            # than refusing.
            unsupported = {
                "repetition_penalty": (p["repetition_penalty"], 1.0),
                "length_penalty": (p["length_penalty"], 1.0),
                "beam_width": (p["beam_width"], 1),
                "bad_words": (list(p.get("bad_words", [])), []),
            }
            bad = [k for k, (v, default) in unsupported.items()
                   if v != default]
            if bad:
                raise ValueError(
                    f"mode='http' does not support {bad}; use mode='grpc'")
            it = self._http().stream(
                prompt, max_tokens=p["max_tokens"], stop=p["stop_words"],
                temperature=p["temperature"], top_k=p["top_k"],
                top_p=p["top_p"])
        for text in it:
            chunk = GenerationChunk(text=text)
            if run_manager is not None and HAVE_LANGCHAIN:
                run_manager.on_llm_new_token(text, chunk=chunk)
            yield chunk


class TorchJobsLLM(_LCLLM):
    """LangChain LLM over the async job API (submit-then-poll).

    The client-side counterpart of the reference's cloud-function
    connector (nv_aiplay.py:222-316): generation goes through
    POST /v1/jobs + 202 polling via ``serving.client.JobsClient``, which
    survives load-balancer/request timeouts that kill a streaming call.
    ``model_name`` resolves against the server's /v1/models registry
    with exact-then-substring matching, as the reference resolves NVCF
    function names. No token streaming — per-chunk delivery is what the
    job API exists to avoid; use ``TorchLLM`` for streaming.
    """

    server_url: str = ""
    model_name: str = ""             # "" = server default; else resolved
    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 1
    tokens: int = 100
    timeout: float = 300.0
    poll_interval: float = 0.25

    model_config = {"arbitrary_types_allowed": True, "extra": "allow"}

    @property
    def _llm_type(self) -> str:
        return "torch_jobs_llm"

    @property
    def _identifying_params(self) -> dict:
        return {"server_url": self.server_url,
                "model_name": self.model_name}

    def _client(self):
        client = getattr(self, "_jobs_client", None)
        if client is None:
            from ..serving.client import JobsClient
            client = JobsClient(self.server_url, timeout=self.timeout,
                                poll_interval=self.poll_interval)
            if self.model_name:
                # resolve against the GENERATION entries only (the
                # registry also lists the embeddings pseudo-model) and
                # remember the result — it is sent with every job
                models = {k: v for k, v in client.available_models().items()
                          if k != "embeddings"}
                name = self.model_name
                resolved = name if name in models else next(
                    (k for k in sorted(models) if name in k), None)
                if resolved is None:
                    raise ValueError(
                        f"unknown model name {name!r}; server has "
                        f"{sorted(models)}")
                object.__setattr__(self, "_resolved_model", resolved)
            object.__setattr__(self, "_jobs_client", client)
        return client

    def _call(self, prompt: str, stop: Optional[List[str]] = None,
              run_manager: Optional[CallbackManagerForLLMRun] = None,
              **kwargs: Any) -> str:
        client = self._client()
        params = {"max_tokens": self.tokens, "temperature": self.temperature,
                  "top_k": self.top_k, "top_p": self.top_p, **kwargs}
        resolved = getattr(self, "_resolved_model", "")
        if resolved:
            params["model"] = resolved
        if stop is not None:
            params["stop"] = list(stop)
        return client.generate(prompt, **params)


class TorchEmbeddings(_LCEmbeddings):
    """LangChain Embeddings over the stack's encoder endpoints, with the
    passage/query input-type split of the reference's NeMo embedder
    (reference: integrations/langchain/embeddings/nemo_embed.py:96-102)."""

    server_url: str = ""
    mode: str = "grpc"               # "grpc" | "http" (/v1/embeddings)
    model_name: str = "e5-large-v2"
    timeout: float = 60.0

    model_config = {"arbitrary_types_allowed": True, "extra": "allow"}

    def _grpc(self):
        client = getattr(self, "_grpc_client", None)
        if client is None:
            from ..serving.grpc_server import GrpcLLMClient
            client = GrpcLLMClient(self.server_url, timeout=self.timeout)
            object.__setattr__(self, "_grpc_client", client)
        return client

    def _embed_http(self, texts: List[str], input_type: str):
        import json

        from ..serving.client import post_with_retry
        url = self.server_url.rstrip("/") + "/v1/embeddings"
        with post_with_retry(url, {
                "model": self.model_name, "input": texts,
                "input_type": input_type}, timeout=self.timeout) as resp:
            data = sorted(json.loads(resp.read())["data"],
                          key=lambda d: d["index"])
        return [d["embedding"] for d in data]

    def embed_documents(self, texts: List[str]) -> List[List[float]]:
        if self.mode == "grpc":
            return self._grpc().embed(texts, "passage").tolist()
        return self._embed_http(texts, "passage")

    def embed_query(self, text: str) -> List[float]:
        if self.mode == "grpc":
            return self._grpc().embed([text], "query")[0].tolist()
        return self._embed_http([text], "query")[0]
