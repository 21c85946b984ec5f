"""LlamaIndex connector classes for the port's serving stack (a port of the
reference package's ``integrations/llamaindex_tpu.py``; the classes are
named ``Torch*`` here): a ``CustomLLM`` for completions and a
``BaseEmbedding`` for the encoder, over the endpoints of
``langchain_torch``. Import-degrades like ``langchain_torch``: real
LlamaIndex base classes when installed, structural stand-ins otherwise.
"""

from __future__ import annotations

from typing import Any, List, Optional

try:
    from llama_index.core.base.embeddings.base import BaseEmbedding as _LIEmb
    from llama_index.core.llms import (CompletionResponse,
                                       CompletionResponseGen, CustomLLM,
                                       LLMMetadata)
    from llama_index.core.llms.callbacks import (llm_completion_callback)
    HAVE_LLAMAINDEX = True
except ImportError:
    HAVE_LLAMAINDEX = False

    class CompletionResponse:  # type: ignore[no-redef]
        def __init__(self, text: str = "", delta: str = ""):
            self.text = text
            self.delta = delta

    CompletionResponseGen = Any  # type: ignore[assignment,misc]

    class LLMMetadata:  # type: ignore[no-redef]
        def __init__(self, **kw: Any):
            for k, v in kw.items():
                setattr(self, k, v)

    def llm_completion_callback():  # type: ignore[no-redef]
        def deco(fn):
            return fn
        return deco

    class CustomLLM:  # type: ignore[no-redef]
        def __init__(self, **kwargs: Any):
            for k, v in kwargs.items():
                setattr(self, k, v)

    class _LIEmb:  # type: ignore[no-redef]
        def __init__(self, **kwargs: Any):
            for k, v in kwargs.items():
                setattr(self, k, v)


class TorchLlamaIndexLLM(CustomLLM):
    """LlamaIndex CustomLLM over the port's serving stack (gRPC or OpenAI
    HTTP), the role the Triton connector plays in the reference's
    ``set_service_context`` (common/utils.py:122-140)."""

    server_url: str = ""
    model_name: str = "ensemble"
    mode: str = "grpc"
    temperature: float = 1.0
    top_k: int = 1
    top_p: float = 0.0
    tokens: int = 100
    context_window: int = 3000       # reference max_input_length
    timeout: float = 120.0

    model_config = {"arbitrary_types_allowed": True, "extra": "allow"}

    @property
    def metadata(self) -> LLMMetadata:
        return LLMMetadata(context_window=self.context_window,
                           num_output=self.tokens,
                           model_name=self.model_name)

    def _delegate(self):
        llm = getattr(self, "_torch_llm", None)
        if llm is None:
            from .langchain_torch import TorchLLM
            llm = TorchLLM(server_url=self.server_url,
                         model_name=self.model_name, mode=self.mode,
                         temperature=self.temperature, top_k=self.top_k,
                         top_p=self.top_p, tokens=self.tokens,
                         timeout=self.timeout)
            object.__setattr__(self, "_torch_llm", llm)
        return llm

    @llm_completion_callback()
    def complete(self, prompt: str, formatted: bool = False,
                 **kwargs: Any) -> CompletionResponse:
        text = self._delegate()._call(prompt, **kwargs)
        return CompletionResponse(text=text)

    @llm_completion_callback()
    def stream_complete(self, prompt: str, formatted: bool = False,
                        **kwargs: Any) -> "CompletionResponseGen":
        def gen():
            acc = ""
            for chunk in self._delegate()._stream(prompt, **kwargs):
                acc += chunk.text
                yield CompletionResponse(text=acc, delta=chunk.text)
        return gen()


class TorchLlamaIndexEmbedding(_LIEmb):
    """LlamaIndex embedding model over the stack's encoder (passage/query
    modes, reference: nemo_embed.py:96-102)."""

    server_url: str = ""
    mode: str = "grpc"
    model_name: str = "e5-large-v2"
    timeout: float = 60.0

    model_config = {"arbitrary_types_allowed": True, "extra": "allow"}

    def _delegate(self):
        emb = getattr(self, "_torch_emb", None)
        if emb is None:
            from .langchain_torch import TorchEmbeddings
            emb = TorchEmbeddings(server_url=self.server_url, mode=self.mode,
                                model_name=self.model_name,
                                timeout=self.timeout)
            object.__setattr__(self, "_torch_emb", emb)
        return emb

    def _get_query_embedding(self, query: str) -> List[float]:
        return self._delegate().embed_query(query)

    def _get_text_embedding(self, text: str) -> List[float]:
        return self._delegate().embed_documents([text])[0]

    def _get_text_embeddings(self, texts: List[str]) -> List[List[float]]:
        return self._delegate().embed_documents(texts)

    async def _aget_query_embedding(self, query: str) -> List[float]:
        return self._get_query_embedding(query)

    async def _aget_text_embedding(self, text: str) -> List[float]:
        return self._get_text_embedding(text)

    # convenience aliases usable without LlamaIndex installed
    def get_query_embedding(self, query: str) -> List[float]:
        if HAVE_LLAMAINDEX:
            return super().get_query_embedding(query)
        return self._get_query_embedding(query)

    def get_text_embedding(self, text: str) -> List[float]:
        if HAVE_LLAMAINDEX:
            return super().get_text_embedding(text)
        return self._get_text_embedding(text)
