"""Embedding service: a batch encoder with passage/query modes — port of
the reference package's ``embed/encoder.py``.

Texts are prefixed ``passage: `` / ``query: `` (the e5 convention), cut
to ``max_length`` tokens, padded to a batch bucket (1, 8, 32) and a
sequence bucket (128, 512), encoded, mean-pooled and L2-normalized.
Tokens and mask go to the device in one copy from pinned memory (the
reference's single packed transfer). On the card the encoder runs on a
stream of its own, so its work never queues behind the engine's
replayed rounds on the default stream.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..models import encoder as enc
from ..models.configs import ENCODER_REGISTRY, EncoderConfig
from ..models.tokenizer import Tokenizer, get_tokenizer
from ..obs.tracing import record_stage
from ..utils.app_config import refuse_tpu_name
from ..utils.device import resolve_device
from ..utils.errors import ConfigError


class EmbeddingService:
    """Batched text embedding on the parameters' device."""

    def __init__(self, params, cfg: EncoderConfig, tokenizer: Tokenizer,
                 max_length: int = 512,
                 batch_buckets: Sequence[int] = (1, 8, 32),
                 seq_buckets: Sequence[int] = (128, 512),
                 normalize: bool = True):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_length = min(max_length, cfg.max_position_embeddings)
        self.batch_buckets = tuple(sorted(batch_buckets))
        # A chat query is ~20 tokens: it takes the short bucket instead of
        # a full-length encoder pass on the retrieve path.
        self.seq_buckets = tuple(sorted(
            {min(s, self.max_length) for s in seq_buckets}
            | {self.max_length}))
        self.normalize = normalize
        self.params = params
        self.device = params["embed"]["word"].device
        self._stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The weights were written on the current stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    # The e5 prefix convention (also what the NeMo embedder maps its
    # passage/query input_type onto).
    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self._embed([f"passage: {t}" for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        return self._embed([f"query: {text}"])[0]

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        """Batched query-mode embedding (one bucketed dispatch, not one
        device round trip per text)."""
        return self._embed([f"query: {t}" for t in texts])

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def pack(self, texts: Sequence[str]) -> np.ndarray:
        """(2, B, S) int32 tokens and mask of ``texts`` (at most the
        largest batch bucket), padded to their buckets."""
        B = self._bucket(len(texts))
        encoded = [self.tokenizer.encode(t)[:self.max_length] for t in texts]
        longest = max((len(ids) for ids in encoded), default=1)
        S = next(s for s in self.seq_buckets if longest <= s)
        packed = np.zeros((2, B, S), np.int32)
        for i, ids in enumerate(encoded):
            packed[0, i, :len(ids)] = ids
            packed[1, i, :len(ids)] = 1
        return packed

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.cfg.hidden_size), np.float32)
        maxb = self.batch_buckets[-1]
        for start in range(0, len(texts), maxb):
            chunk = texts[start:start + maxb]
            out[start:start + len(chunk)] = self._embed_chunk(chunk)
        return out

    def _embed_chunk(self, texts: Sequence[str]) -> np.ndarray:
        host = torch.from_numpy(self.pack(texts))
        on_card = self._stream is not None
        ctx = (torch.cuda.stream(self._stream) if on_card
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            t0 = time.monotonic()
            packed = (host.pin_memory().to(self.device, non_blocking=True)
                      if on_card else host)
            hidden = enc.apply(self.params, self.cfg, packed[0], packed[1])
            emb = enc.mean_pool(hidden, packed[1], normalize=self.normalize)
            t1 = time.monotonic()
            # The copy back waits for this stream's work, and the pinned
            # input's copy with it.
            out = emb.cpu().numpy()[:len(texts)]
        record_stage("embed_dispatch", t1 - t0)
        record_stage("embed_readback", time.monotonic() - t1)
        return out


class HashEmbedder:
    """Deterministic no-model embedder for tests and air-gapped dev: embeds
    by hashing character n-grams, so similar texts get similar vectors."""

    def __init__(self, dim: int = 64):
        self._dim = dim

    @property
    def dim(self) -> int:
        return self._dim

    def _vec(self, text: str) -> np.ndarray:
        v = np.zeros(self._dim, np.float32)
        t = text.lower()
        for n in (3, 4):
            for i in range(max(0, len(t) - n + 1)):
                gram = t[i:i + n]
                h = int.from_bytes(
                    hashlib.md5(gram.encode()).digest()[:8], "little")
                v[h % self._dim] += 1.0
        norm = np.linalg.norm(v)
        return v / norm if norm > 0 else v

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self._vec(f"passage: {t}") for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        return self._vec(f"passage: {text}")

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.embed_query(t) for t in texts])


def get_embedder(model_engine: str = "torch-cuda",
                 model_name: str = "intfloat/e5-large-v2",
                 checkpoint_path: Optional[str] = None,
                 dim: int = 64,
                 device: Union[str, torch.device] = "cuda"):
    """Factory. Engines: ``torch-cuda`` (the encoder on ``device``: random
    float32 weights from seed 0 and the byte tokenizer, or an HF BERT
    checkpoint directory's safetensors and tokenizer), ``hash`` (the test
    double)."""
    refuse_tpu_name("embeddings.model_engine", model_engine)
    if model_engine == "hash":
        return HashEmbedder(dim=dim)
    if model_engine != "torch-cuda":
        raise ValueError(f"unknown embedding engine {model_engine!r}")
    if model_name not in ENCODER_REGISTRY:
        raise ConfigError(f"unknown encoder model {model_name!r}; known: "
                          f"{sorted(ENCODER_REGISTRY)}")
    cfg = ENCODER_REGISTRY[model_name]
    dev = resolve_device(device)
    if checkpoint_path:
        if not os.path.isdir(checkpoint_path):
            raise ConfigError("checkpoint_path must be a directory")
        from ..models.import_hf import _iter_safetensors
        params = enc.params_from_named_tensors(
            _iter_safetensors(checkpoint_path), cfg, device=dev)
        tok = get_tokenizer(checkpoint_path)
    else:
        params = enc.init_params(cfg, seed=0, device=dev)
        tok = get_tokenizer("byte")
    return EmbeddingService(params, cfg, tok)
