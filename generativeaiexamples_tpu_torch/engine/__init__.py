"""Serving engine of the port: continuous batching over a paged KV pool."""

from .engine import Engine, EngineConfig, TokenStream
from .sampling_params import SamplingParams

__all__ = ["Engine", "EngineConfig", "SamplingParams", "TokenStream"]
