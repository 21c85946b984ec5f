"""Chain server: pluggable RAG pipelines behind a 3-endpoint HTTP API — a
port of the reference package's ``chains/``: ``POST /uploadDocument``,
``POST /generate`` (streaming) and ``POST /documentSearch`` served by
aiohttp over this package's own retrieval and engine layers."""

from .base import BaseExample
from .llm import LLM, get_llm
from .splitter import TokenTextSplitter

__all__ = ["BaseExample", "LLM", "get_llm", "TokenTextSplitter"]
