"""Batch embedding service on the device."""

from .encoder import EmbeddingService, HashEmbedder, get_embedder

__all__ = ["EmbeddingService", "HashEmbedder", "get_embedder"]
