"""Application configuration schema — a copy of the reference package's
``utils/app_config.py``.

``VectorStoreConfig`` / ``LLMConfig`` / ``TextSplitterConfig`` /
``EmbeddingConfig`` / ``PromptsConfig`` / ``RetrieverConfig`` /
``EngineConfig`` / ``ServingRobustnessConfig`` / ``AppConfig`` keep the
reference's fields, defaults and env names. The engine and store names
are the port's: ``torch-cuda`` (the in-process engine and the on-card
embedder) and ``exact-cuda`` (the exact store searched on the card). The
reference's names for its TPU backends (``tpu-jax``, ``tpu-http``,
``exact-tpu``) raise ``ConfigError`` naming the port's; nothing is
aliased silently.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .configuration import configfield, from_file
from .errors import ConfigError

#: The reference's names for its TPU backends, and the port's name for
#: the same role.
TPU_NAMES = {"tpu-jax": "torch-cuda", "tpu-http": "openai-compat",
             "exact-tpu": "exact-cuda"}


def refuse_tpu_name(field_path: str, value: str) -> None:
    """Raise ``ConfigError`` for a reference TPU backend name, naming the
    port's."""
    if value in TPU_NAMES:
        raise ConfigError(
            f"{field_path}={value!r} names a TPU backend of the JAX "
            f"package; this package serves {TPU_NAMES[value]!r}")

# Default prompt templates: Llama-2 [INST] chat formats, parity with
# reference common/configuration.py:124-156 (PromptsConfig defaults).
CHAT_TEMPLATE = (
    "<s>[INST] <<SYS>>\n"
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe. Please ensure that your "
    "responses are positive in nature.\n"
    "<</SYS>>\n\n"
    "{context_str} {query_str} [/INST]"
)

RAG_TEMPLATE = (
    "<s>[INST] <<SYS>>\n"
    "Use the following context to answer the user's question. If you don't "
    "know the answer, just say that you don't know, don't try to make up an "
    "answer.\n"
    "<</SYS>>\n\n"
    "<s>[INST] Context: {context_str} Question: {query_str} Only return the "
    "helpful answer below and nothing else. Helpful answer: [/INST]"
)


@dataclass(frozen=True)
class VectorStoreConfig:
    """Reference: common/configuration.py:20-47."""
    name: str = configfield("name", default="exact",
                            help_txt="vector store backend: exact | exact-cuda | ivfflat | milvus | pgvector")
    url: str = configfield("url", default="",
                           help_txt="remote store URL (milvus/pgvector only)")
    nlist: int = configfield("nlist", default=64,
                             help_txt="IVF cluster count (reference milvus GPU_IVF_FLAT nlist)")
    nprobe: int = configfield("nprobe", default=16,
                              help_txt="IVF clusters probed per query")

    def __post_init__(self) -> None:
        refuse_tpu_name("vector_store.name", self.name)


@dataclass(frozen=True)
class LLMConfig:
    """Reference: common/configuration.py:50-72."""
    server_url: str = configfield("server_url", default="",
                                  help_txt="URL of the inference server ('' = in-process engine)")
    model_name: str = configfield("model_name", default="llama-2-7b-chat",
                                  help_txt="served model name")
    model_engine: str = configfield("model_engine", default="torch-cuda",
                                    help_txt="torch-cuda | openai-compat | echo (testing)")

    def __post_init__(self) -> None:
        refuse_tpu_name("llm.model_engine", self.model_engine)


@dataclass(frozen=True)
class TextSplitterConfig:
    """Reference: common/configuration.py:75-92 (510/200 on e5 tokenizer)."""
    chunk_size: int = configfield("chunk_size", default=510,
                                  help_txt="tokens per chunk")
    chunk_overlap: int = configfield("chunk_overlap", default=200,
                                     help_txt="token overlap between chunks")


@dataclass(frozen=True)
class EmbeddingConfig:
    """Reference: common/configuration.py:95-121 (e5-large-v2, 1024-d)."""
    model_name: str = configfield("model_name", default="intfloat/e5-large-v2",
                                  help_txt="embedding model")
    dimensions: int = configfield("dimensions", default=1024,
                                  help_txt="embedding dimensionality")
    model_engine: str = configfield("model_engine", default="torch-cuda",
                                    help_txt="torch-cuda | hash (testing)")

    def __post_init__(self) -> None:
        refuse_tpu_name("embeddings.model_engine", self.model_engine)


@dataclass(frozen=True)
class PromptsConfig:
    """Reference: common/configuration.py:124-156."""
    chat_template: str = configfield("chat_template", default=CHAT_TEMPLATE,
                                     help_txt="non-KB chat prompt template")
    rag_template: str = configfield("rag_template", default=RAG_TEMPLATE,
                                    help_txt="KB-augmented prompt template")


@dataclass(frozen=True)
class RetrieverConfig:
    """Retrieval behavior defaults (reference: chains.py:117 top-4,
    common/utils.py:91 1500-token context cap)."""
    top_k: int = configfield("top_k", default=4, help_txt="documents retrieved per query")
    max_context_tokens: int = configfield("max_context_tokens", default=1500,
                                          help_txt="token cap on stuffed retrieved context")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (the reference's section, kept for its schema;
    the port serves one card)."""
    tp: int = configfield("tp", default=0,
                          help_txt="tensor-parallel size (0 = all local devices)")
    pp: int = configfield("pp", default=1, help_txt="pipeline-parallel stages")
    dp: int = configfield("dp", default=1, help_txt="data-parallel replicas")
    ep: int = configfield("ep", default=1, help_txt="expert-parallel size (MoE)")


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine limits — parity with the reference's engine-build
    defaults (reference: model_server/__main__.py:81-92 max in/out,
    ensemble_models/llama/tensorrt_llm/config.pbtxt.j2:29 max batch)."""
    max_input_length: int = configfield("max_input_length", default=3000)
    max_output_length: int = configfield("max_output_length", default=512)
    max_batch_size: int = configfield("max_batch_size", default=128)
    page_size: int = configfield("page_size", default=128,
                                 help_txt="KV-cache page size in tokens")
    prefill_buckets: list[int] = configfield(
        "prefill_buckets", default_factory=lambda: [128, 512, 1024, 2048, 3072],
        help_txt="static prefill padding buckets")
    dtype: str = configfield("dtype", default="bfloat16",
                             help_txt="activation/weight dtype on the device")
    quantization: str = configfield("quantization", default="",
                                    help_txt="'' | int8 | int4_awq (reference: conversion/llama.py:81-97)")


@dataclass(frozen=True)
class ServingRobustnessConfig:
    """Deadline/overload behavior at the HTTP edges (chain server and
    OpenAI API). Env overlay: ``APP_SERVING_*`` (configuration.py)."""
    default_deadline_ms: float = configfield(
        "default_deadline_ms", default=0.0,
        help_txt="deadline applied when no X-Deadline-Ms header is sent "
                 "(0 = none)")
    request_timeout_s: float = configfield(
        "request_timeout_s", default=30.0,
        help_txt="executor timeout for documentSearch; a hung store "
                 "returns 504 instead of pinning a worker")
    ingest_timeout_s: float = configfield(
        "ingest_timeout_s", default=300.0,
        help_txt="executor timeout for uploadDocument ingest — separate "
                 "knob: chunking+embedding a large file is legitimately "
                 "slow where a search is not")
    breaker_failures: int = configfield(
        "breaker_failures", default=5,
        help_txt="consecutive generate failures before the engine "
                 "breaker opens (fast-503)")
    breaker_cooldown_s: float = configfield(
        "breaker_cooldown_s", default=15.0,
        help_txt="seconds an open breaker waits before a half-open probe")
    admission_min_samples: int = configfield(
        "admission_min_samples", default=4,
        help_txt="completed requests needed before queue-wait-based "
                 "admission shedding activates")


@dataclass(frozen=True)
class TracingConfig:
    enabled: bool = configfield("enabled", default=False,
                                help_txt="enable OpenTelemetry tracing (reference gates on ENABLE_TRACING)")
    otlp_endpoint: str = configfield("otlp_endpoint", default="http://localhost:4317")


@dataclass(frozen=True)
class AppConfig:
    """Root config (reference: common/configuration.py:158-170)."""
    vector_store: VectorStoreConfig = field(default_factory=VectorStoreConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    text_splitter: TextSplitterConfig = field(default_factory=TextSplitterConfig)
    embeddings: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    prompts: PromptsConfig = field(default_factory=PromptsConfig)
    retriever: RetrieverConfig = field(default_factory=RetrieverConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    serving: ServingRobustnessConfig = field(
        default_factory=ServingRobustnessConfig)


_CONFIG_SINGLETON: AppConfig | None = None


def get_config(path: str | None = None, *, reload: bool = False) -> AppConfig:
    """Load-once config accessor.

    Parity with ``get_config`` (reference: common/utils.py:133-140): reads
    the file named by ``$APP_CONFIG_FILE`` unless an explicit path is given.
    """
    global _CONFIG_SINGLETON
    if path is not None:
        # Explicit-path loads are one-off: they must not reconfigure every
        # later bare get_config() caller in the process.
        return from_file(AppConfig, path)
    if _CONFIG_SINGLETON is None or reload:
        import os
        _CONFIG_SINGLETON = from_file(AppConfig, os.environ.get("APP_CONFIG_FILE"))
    return _CONFIG_SINGLETON
