"""Exact top-k on the device: one matmul over the stored base, then a top-k
— port of the reference package's ``retrieval/tpu_search.py``.

The base lives on the device as one bfloat16 (N, D) matrix, rows padded
to a multiple of 128 and the padding masked dead. A search scores the
queries against every row in one matrix product of bfloat16 operands
with float32 sums and a float32 result — what XLA makes of the
reference's jitted ``(q.astype(bf16) @ base.T).astype(f32)``: it folds
the cast into the product, so its scores are never rounded to bfloat16
— applies the ``l2`` correction and the live mask, and selects the top
k. The reference left this to XLA, not Pallas, so library calls are the
port.

Ties come out lowest id first, as ``lax.top_k`` orders them: each score
is packed with its row's id into one int64 key (the score's order-
preserving bits above, the complement of the id below), so one
``torch.topk`` over distinct keys fixes the order. Duplicate chunks,
which overlapping splits and repeated boilerplate make, tie exactly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device


def topk_lowest_id_first(scores: torch.Tensor,
                         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest float32 ``scores`` per row,
    equal values ordered by ascending index (``lax.top_k``'s order)."""
    bits = scores.contiguous().view(torch.int32)
    # Flip the magnitude bits of negative floats: signed-int order of the
    # result is the float order (for every non-NaN value, -inf included).
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    ids = torch.arange(scores.shape[-1], device=scores.device,
                       dtype=torch.int64)
    keys = ordered.to(torch.int64) * (1 << 32) + (0xFFFFFFFF - ids)
    idx = torch.topk(keys, k, dim=-1).indices
    return scores.gather(-1, idx), idx


def scores_f32(q: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(Q, N) float32 ``q @ base.T`` of bfloat16 operands, summed and
    returned in float32. On the card one cuBLAS product writes float32
    (``out_dtype``); the CPU has no such product, and widens both
    operands instead, which gives the same exact products."""
    q = q.to(torch.bfloat16)
    if base.is_cuda:
        return torch.mm(q, base.T, out_dtype=torch.float32)
    return q.float() @ base.float().T


def search_scores(base: torch.Tensor, sq: torch.Tensor, mask: torch.Tensor,
                  q: torch.Tensor, k: int,
                  metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores, ids) of float32 queries ``q`` (Q, D) over the
    bfloat16 ``base`` (N, D) with float32 squared norms ``sq`` and live
    ``mask`` (N,)."""
    scores = scores_f32(q, base)
    if metric == "l2":
        q_sq = torch.einsum("qd,qd->q", q, q)
        scores = 2.0 * scores - sq[None, :] - q_sq[:, None]
    scores = scores.masked_fill(mask[None, :] <= 0, float("-inf"))
    return topk_lowest_id_first(scores, k)


class _CudaBackend:
    """Device-resident copy of a store's base matrix with its search."""

    def __init__(self, base: np.ndarray, live: Optional[np.ndarray],
                 metric: str, device: Union[str, torch.device] = "cuda"):
        self.metric = metric
        self.device = resolve_device(device)
        n = base.shape[0]
        n_pad = max(8, -(-n // 128) * 128)
        data = np.zeros((n_pad, base.shape[1]), np.float32)
        data[:n] = base
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0 if live is None else live.astype(np.float32)
        full = torch.from_numpy(data).to(self.device)
        self.base = full.to(torch.bfloat16)
        self.sq = torch.einsum("nd,nd->n", full, full)
        self.mask = torch.from_numpy(mask).to(self.device)
        del full

    def search(self, queries: np.ndarray,
               k: int) -> tuple[np.ndarray, np.ndarray]:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.device)
        with torch.inference_mode():
            top_scores, top_idx = search_scores(self.base, self.sq,
                                                self.mask, q, k, self.metric)
            idx = top_idx.cpu().numpy().astype(np.int64)
            sc = top_scores.cpu().numpy().astype(np.float32)
        idx = np.where(np.isfinite(sc), idx, -1)
        return idx, sc
