"""LLM client abstraction for the chains layer — port of the reference
package's ``chains/llm.py``. Engines:

- ``torch-cuda``    this package's in-process continuous-batching
                    ``Engine`` (``EngineLLM``).
- ``openai-compat`` HTTP client for any OpenAI-style ``/v1/completions``
                    server — this package's own model server included.
- ``echo``          deterministic test double.

``EngineLLM.stream_rag`` is the fused-RAG generation: retrieval, prompt
assembly and prefill as one program inside the engine's admission
(``engine/rag_fusion.py``).
"""

from __future__ import annotations

import abc
import json
import time
import urllib.request
from typing import Iterator, Optional

from ..utils.errors import ConfigError


class LLM(abc.ABC):
    """Minimal streaming text-completion interface used by all chains."""

    @abc.abstractmethod
    def stream(self, prompt: str, max_tokens: int = 256,
               stop: Optional[list[str]] = None, temperature: float = 1.0,
               top_k: int = 1, top_p: float = 0.0,
               ) -> Iterator[str]:
        """Yield answer text chunks. Default sampling mirrors the
        reference's client defaults (temperature 1.0, top_k 1: greedy)."""

    def complete(self, prompt: str, **kw) -> str:
        return "".join(self.stream(prompt, **kw))


class EchoLLM(LLM):
    """Deterministic test double: echoes a transform of the prompt tail."""

    def __init__(self, prefix: str = "ECHO: ", tail_chars: int = 160):
        self.prefix = prefix
        self.tail_chars = tail_chars
        self.calls: list[str] = []

    def stream(self, prompt: str, max_tokens: int = 256,
               stop: Optional[list[str]] = None, temperature: float = 1.0,
               top_k: int = 1, top_p: float = 0.0) -> Iterator[str]:
        self.calls.append(prompt)
        tail = prompt[-self.tail_chars:]
        # A real model never echoes its chat scaffold; scrub template
        # markers so caller-supplied stop words don't trip on the echo.
        for marker in ("<s>", "</s>", "[INST]", "[/INST]",
                       "<<SYS>>", "<</SYS>>"):
            tail = tail.replace(marker, "")
        text = (self.prefix + tail)[:max_tokens]
        for s in stop or []:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        for i in range(0, len(text), 7):  # chunked like a real stream
            yield text[i:i + 7]


class EngineLLM(LLM):
    """The in-process engine: no network hop, the engine lives in this
    process. A stream the consumer abandons is cancelled, so its decode
    slot is released instead of generating to ``max_tokens``."""

    def __init__(self, engine):
        self.engine = engine
        engine.start()

    def stream(self, prompt: str, max_tokens: int = 256,
               stop: Optional[list[str]] = None, temperature: float = 1.0,
               top_k: int = 1, top_p: float = 0.0) -> Iterator[str]:
        from ..engine.sampling_params import SamplingParams
        params = SamplingParams(max_tokens=max_tokens,
                                stop_words=list(stop or []),
                                temperature=temperature, top_k=top_k,
                                top_p=top_p)
        stream = self.engine.stream_text(prompt, params)
        yield from self._consume(stream, time.monotonic())

    def stream_rag(self, question: str, enc_ids: list,
                   max_tokens: int = 256,
                   stop: Optional[list[str]] = None,
                   temperature: float = 1.0, top_k: int = 1,
                   top_p: float = 0.0, on_sources=None,
                   q_ids: Optional[list] = None) -> Iterator[str]:
        """Fused-RAG generation: retrieval, prompt assembly and prefill
        run as one device program inside the engine. ``enc_ids``: the
        question's tokens in the encoder's vocabulary, query prefix
        included. ``on_sources`` (optional) receives the retrieved corpus
        rows once they are known, with the first chunk. ``q_ids``: the
        question already tokenized in the LLM's vocabulary (callers that
        checked its length pass it, so it is tokenized once)."""
        from ..engine.sampling_params import SamplingParams
        params = SamplingParams(max_tokens=max_tokens,
                                stop_words=list(stop or []),
                                temperature=temperature, top_k=top_k,
                                top_p=top_p)
        self.engine.start()
        if q_ids is None:
            q_ids = self.engine.tokenizer.encode(question, add_bos=False)
        stream = self.engine.submit_rag(q_ids, enc_ids, params)
        yield from self._consume(stream, time.monotonic(),
                                 on_sources=on_sources)

    def _consume(self, stream, t0: float,
                 on_sources=None) -> Iterator[str]:
        from ..obs.tracing import record_stage
        first = True
        try:
            for chunk in stream:
                if first:
                    # Time from submission to the first visible chunk
                    # (queue + prefill + detokenize). engine_ttft is the
                    # engine's own, recorded at the first token's harvest.
                    record_stage("llm_first_chunk", time.monotonic() - t0)
                    if on_sources is not None and stream.source_ids:
                        on_sources(stream.source_ids)
                    first = False
                yield chunk
        finally:
            if stream.finish_reason is None:
                # The consumer abandoned the generator mid-stream.
                stream.cancel()


class OpenAICompatLLM(LLM):
    """Streaming client for ``/v1/completions`` SSE servers (true deltas,
    passed through as they come). Uses ``urllib.request``: no client
    package is needed."""

    def __init__(self, server_url: str, model_name: str = "default",
                 timeout: float = 120.0, send_top_k: bool = True):
        if not server_url:
            raise ConfigError("openai-compat engine requires llm.server_url")
        self.url = server_url.rstrip("/") + "/v1/completions"
        self.model_name = model_name
        self.timeout = timeout
        # top_k is this framework's extension; disable against servers that
        # reject unknown sampling arguments.
        self.send_top_k = send_top_k

    def stream(self, prompt: str, max_tokens: int = 256,
               stop: Optional[list[str]] = None, temperature: float = 1.0,
               top_k: int = 1, top_p: float = 0.0) -> Iterator[str]:
        body = {"model": self.model_name, "prompt": prompt,
                "max_tokens": max_tokens, "stream": True,
                "temperature": temperature, "top_p": top_p,
                "stop": list(stop or [])}
        if top_k == 1:
            # top_k == 1 means greedy regardless of temperature; express it
            # as temperature 0, portable to servers that reject
            # non-standard arguments.
            body["temperature"] = 0.0
        elif top_k > 1 and self.send_top_k:
            body["top_k"] = top_k
        req = urllib.request.Request(
            self.url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        # urlopen raises HTTPError on a status >= 400.
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if not line.startswith("data:"):
                    continue
                payload = line[len("data:"):].strip()
                if payload == "[DONE]":
                    return
                choice = json.loads(payload)["choices"][0]
                if choice.get("text"):
                    yield choice["text"]


def get_llm(config=None, engine=None) -> LLM:
    """Engine-switched factory (the config refuses the reference's TPU
    engine names)."""
    if config is None:
        from ..utils.app_config import get_config
        config = get_config()
    kind = config.llm.model_engine
    if kind == "echo":
        return EchoLLM()
    if kind == "torch-cuda":
        if engine is None:
            raise ConfigError(
                "model_engine=torch-cuda needs an in-process Engine "
                "instance (pass engine=); for a remote server use "
                "openai-compat")
        return EngineLLM(engine)
    if kind == "openai-compat":
        return OpenAICompatLLM(config.llm.server_url, config.llm.model_name)
    raise ConfigError(f"unknown llm.model_engine {kind!r}")
