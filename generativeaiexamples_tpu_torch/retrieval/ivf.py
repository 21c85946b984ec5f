"""First-party IVF-Flat ANN store (a copy of the reference package's
``retrieval/ivf.py``).

Parameter parity with the reference's Milvus GPU_IVF_FLAT defaults —
nlist=64, nprobe=16 (reference: common/utils.py:181-186,
common/configuration.py:38-47). K-means runs in numpy (nlist is small);
search scans the nprobe nearest clusters' postings via the native C++
kernel when available, numpy otherwise.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from .store import SearchHit, VectorStore, _as_2d, score_matrix


def kmeans(data: np.ndarray, n_clusters: int, iters: int = 20,
           seed: int = 0) -> np.ndarray:
    """Lloyd's k-means; returns (n_clusters, D) centroids."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    centroids = data[rng.choice(n, size=min(n_clusters, n), replace=False)]
    if centroids.shape[0] < n_clusters:  # fewer points than clusters
        extra = rng.standard_normal(
            (n_clusters - centroids.shape[0], data.shape[1])).astype(np.float32)
        centroids = np.concatenate([centroids, extra])
    for _ in range(iters):
        assign = assign_clusters(data, centroids)
        for c in range(n_clusters):
            members = data[assign == c]
            if len(members):
                centroids[c] = members.mean(axis=0)
    return centroids


def assign_clusters(data: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    d2 = (np.einsum("nd,nd->n", data, data)[:, None]
          - 2.0 * data @ centroids.T
          + np.einsum("cd,cd->c", centroids, centroids)[None, :])
    return np.argmin(d2, axis=1).astype(np.int64)


class IVFFlatStore(VectorStore):
    def __init__(self, dim: int, metric: str = "ip", nlist: int = 64,
                 nprobe: int = 16, train_min: Optional[int] = None):
        if metric not in ("ip", "l2"):
            raise ValueError(f"metric must be ip|l2, got {metric!r}")
        self._dim = dim
        self.metric = metric
        self.nlist = nlist
        self.nprobe = nprobe
        # Below this corpus size search just brute-forces (and no train).
        self.train_min = train_min if train_min is not None else 4 * nlist
        self._rows: list[np.ndarray] = []
        self._live_list: list[bool] = []
        self._deleted = 0
        self._index: Optional[dict] = None  # centroids/offsets/items/base/...

    @property
    def dim(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._rows) - self._deleted

    def add(self, embeddings: np.ndarray) -> list[int]:
        emb = _as_2d(embeddings)
        if emb.shape[1] != self._dim:
            raise ValueError(f"dim mismatch: store {self._dim}, got {emb.shape[1]}")
        start = len(self._rows)
        for row in emb:
            self._rows.append(np.ascontiguousarray(row, np.float32))
            self._live_list.append(True)
        self._index = None  # lazily rebuilt on next search
        return list(range(start, start + emb.shape[0]))

    def delete(self, ids: Sequence[int]) -> None:
        for i in ids:
            if 0 <= i < len(self._rows) and self._live_list[i]:
                self._live_list[i] = False
                self._deleted += 1
        if self._index is not None:
            self._index["live"] = np.asarray(self._live_list, np.uint8)

    # ------------------------------------------------------------- indexing

    def _build(self) -> dict:
        base = np.stack(self._rows) if self._rows else np.zeros(
            (0, self._dim), np.float32)
        live = np.asarray(self._live_list, np.uint8)
        idx: dict = {"base": base, "live": live,
                     "sq": np.einsum("nd,nd->n", base, base)}
        if base.shape[0] >= self.train_min:
            centroids = kmeans(base, self.nlist)
            assign = assign_clusters(base, centroids)
            order = np.argsort(assign, kind="stable").astype(np.int64)
            counts = np.bincount(assign, minlength=self.nlist)
            offsets = np.zeros(self.nlist + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            idx.update(centroids=np.ascontiguousarray(centroids, np.float32),
                       offsets=offsets, items=order)
        return idx

    def search(self, queries: np.ndarray, k: int = 4) -> list[list[SearchHit]]:
        q = np.ascontiguousarray(_as_2d(queries), np.float32)
        if len(self) == 0:
            return [[] for _ in range(q.shape[0])]
        if self._index is None:
            self._index = self._build()
        ix = self._index
        k_eff = min(k, len(self))
        metric_code = 0 if self.metric == "ip" else 1
        any_dead = self._deleted > 0
        live = ix["live"] if any_dead else None
        if "centroids" in ix:
            from . import native
            out = native.ivf_search(ix["base"], ix["centroids"], ix["offsets"],
                                    ix["items"], q, k_eff, self.nprobe,
                                    metric_code,
                                    base_sq=ix["sq"], live=live)
            if out is None:
                out = self._numpy_ivf(ix, q, k_eff)
        else:
            from . import native
            out = native.brute_topk(ix["base"], q, k_eff, metric_code,
                                    base_sq=ix["sq"], live=live)
            if out is None:
                out = self._numpy_brute(ix, q, k_eff)
        idx_arr, score_arr = out
        return [
            [SearchHit(int(i), float(s)) for i, s in zip(ri, rs) if i >= 0]
            for ri, rs in zip(idx_arr, score_arr)
        ]

    def _numpy_brute(self, ix: dict, q: np.ndarray, k: int):
        scores = score_matrix(ix["base"], q, self.metric, base_sqnorm=ix["sq"])
        if self._deleted > 0:
            scores = np.where(ix["live"][None, :] == 1, scores, -np.inf)
        idx = np.argsort(-scores, axis=1)[:, :k]
        top = np.take_along_axis(scores, idx, axis=1)
        idx = np.where(np.isfinite(top), idx, -1)
        return idx.astype(np.int64), top.astype(np.float32)

    def _numpy_ivf(self, ix: dict, q: np.ndarray, k: int):
        nq = q.shape[0]
        idx = np.full((nq, k), -1, np.int64)
        score = np.full((nq, k), -np.inf, np.float32)
        cd2 = (np.einsum("cd,cd->c", ix["centroids"], ix["centroids"])[None, :]
               - 2.0 * q @ ix["centroids"].T)
        probe = np.argsort(cd2, axis=1)[:, :self.nprobe]
        for qi in range(nq):
            cand: list[np.ndarray] = []
            for c in probe[qi]:
                cand.append(ix["items"][ix["offsets"][c]:ix["offsets"][c + 1]])
            ids = np.concatenate(cand) if cand else np.zeros(0, np.int64)
            if self._deleted > 0:
                ids = ids[ix["live"][ids] == 1]
            if not len(ids):
                continue
            sub = score_matrix(ix["base"][ids], q[qi:qi + 1], self.metric,
                               base_sqnorm=ix["sq"][ids])[0]
            order = np.argsort(-sub)[:k]
            idx[qi, :len(order)] = ids[order]
            score[qi, :len(order)] = sub[order]
        return idx, score

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        base = np.stack(self._rows) if self._rows else np.zeros(
            (0, self._dim), np.float32)
        np.savez_compressed(os.path.join(path, "vectors.npz"), data=base,
                            live=np.asarray(self._live_list, np.uint8))
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump({"kind": "ivfflat", "dim": self._dim,
                       "metric": self.metric, "nlist": self.nlist,
                       "nprobe": self.nprobe}, f)

    @classmethod
    def load(cls, path: str) -> "IVFFlatStore":
        with open(os.path.join(path, "store.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "vectors.npz"))
        store = cls(dim=meta["dim"], metric=meta["metric"],
                    nlist=meta["nlist"], nprobe=meta["nprobe"])
        for row, lv in zip(z["data"], z["live"]):
            store._rows.append(np.ascontiguousarray(row, np.float32))
            store._live_list.append(bool(lv))
        store._deleted = int(len(store._rows) - z["live"].sum())
        return store
