"""Exact top-k vector store with numpy / native C++ / CUDA backends — a
copy of the reference package's ``retrieval/exact.py`` with the
reference's "tpu" backend replaced by "cuda".

The FAISS-flat equivalent. One store, three engines:
  - "auto":   native C++ (OpenMP) when the toolchain is up, else numpy.
  - "numpy":  BLAS matmul + argpartition.
  - "cuda":   one matmul + ``torch.topk`` on the device
              (``retrieval/cuda_search.py``), lowest id first at ties.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .store import SearchHit, VectorStore, _as_2d, score_matrix


class ExactStore(VectorStore):
    def __init__(self, dim: int, metric: str = "ip", backend: str = "auto",
                 capacity: int = 1024,
                 device: Union[str, torch.device] = "cuda"):
        if metric not in ("ip", "l2"):
            raise ValueError(f"metric must be ip|l2, got {metric!r}")
        if backend == "tpu":
            raise ValueError("backend 'tpu' is the JAX package's; this "
                             "store's device backend is 'cuda'")
        self._dim = dim
        self.metric = metric
        self.backend = backend
        # The "cuda" backend's device (tests pass "cpu").
        self.device = device
        self._data = np.zeros((capacity, dim), np.float32)
        self._sq = np.zeros((capacity,), np.float32)
        self._live = np.zeros((capacity,), np.uint8)
        self._n = 0
        self._deleted = 0
        self._cuda: Optional["_CudaBackend"] = None

    # ------------------------------------------------------------- plumbing

    @property
    def dim(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return self._n - self._deleted

    def _grow(self, need: int) -> None:
        cap = self._data.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        for name in ("_data", "_sq", "_live"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    # ------------------------------------------------------------------ API

    def add(self, embeddings: np.ndarray) -> list[int]:
        emb = _as_2d(embeddings)
        if emb.shape[1] != self._dim:
            raise ValueError(f"dim mismatch: store {self._dim}, got {emb.shape[1]}")
        n_new = emb.shape[0]
        self._grow(self._n + n_new)
        ids = list(range(self._n, self._n + n_new))
        self._data[self._n:self._n + n_new] = emb
        self._sq[self._n:self._n + n_new] = np.einsum("nd,nd->n", emb, emb)
        self._live[self._n:self._n + n_new] = 1
        self._n += n_new
        self._cuda = None  # device copy invalidated
        return ids

    def delete(self, ids: Sequence[int]) -> None:
        for i in ids:
            if 0 <= i < self._n and self._live[i]:
                self._live[i] = 0
                self._deleted += 1
        self._cuda = None

    def export_vectors(self) -> tuple[list[int], np.ndarray]:
        """(ids, rows) of every live vector — feeds the engine's
        device-resident fused-RAG corpus."""
        live = [i for i in range(self._n) if self._live[i]]
        return live, self._data[live].copy()

    def search(self, queries: np.ndarray, k: int = 4) -> list[list[SearchHit]]:
        q = _as_2d(queries)
        if self._n == 0:
            return [[] for _ in range(q.shape[0])]
        k_eff = min(k, len(self))
        if k_eff == 0:
            return [[] for _ in range(q.shape[0])]
        idx, score = self._dispatch(q, k_eff)
        return [
            [SearchHit(int(i), float(s)) for i, s in zip(ri, rs) if i >= 0]
            for ri, rs in zip(idx, score)
        ]

    def _dispatch(self, q: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        base = self._data[:self._n]
        live = self._live[:self._n]
        any_dead = self._deleted > 0
        if self.backend in ("auto", "native"):
            from . import native
            out = native.brute_topk(
                base, np.ascontiguousarray(q), k,
                0 if self.metric == "ip" else 1,
                base_sq=self._sq[:self._n] if self.metric == "l2" else None,
                live=live if any_dead else None)
            if out is not None:
                return out
            if self.backend == "native":
                raise RuntimeError("native topk backend unavailable")
        if self.backend == "cuda":
            if self._cuda is None:
                from .cuda_search import _CudaBackend
                self._cuda = _CudaBackend(base, live if any_dead else None,
                                          self.metric, device=self.device)
            return self._cuda.search(q, k)
        scores = score_matrix(base, q, self.metric,
                              base_sqnorm=self._sq[:self._n])
        if any_dead:
            scores = np.where(live[None, :] == 1, scores, -np.inf)
        part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        part_scores = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-part_scores, axis=1)
        idx = np.take_along_axis(part, order, axis=1)
        top = np.take_along_axis(part_scores, order, axis=1)
        idx = np.where(np.isfinite(top), idx, -1)
        return idx.astype(np.int64), top.astype(np.float32)

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(os.path.join(path, "vectors.npz"),
                            data=self._data[:self._n],
                            live=self._live[:self._n])
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump({"kind": "exact", "dim": self._dim,
                       "metric": self.metric, "backend": self.backend}, f)

    @classmethod
    def load(cls, path: str) -> "ExactStore":
        with open(os.path.join(path, "store.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "vectors.npz"))
        store = cls(dim=meta["dim"], metric=meta["metric"],
                    backend=meta.get("backend", "auto"),
                    capacity=max(1, z["data"].shape[0]))
        n = z["data"].shape[0]
        store._data[:n] = z["data"]
        store._sq[:n] = np.einsum("nd,nd->n", z["data"], z["data"])
        store._live[:n] = z["live"]
        store._n = n
        store._deleted = int(n - z["live"].sum())
        return store
