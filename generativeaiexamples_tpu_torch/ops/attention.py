"""GQA attention with absolute-position causal masking — port of the
reference's ``ops/attention.py``.

The reference computes prefill attention in XLA (no Pallas kernel), so
this is plain PyTorch, written out rather than calling a fused library
operator so that masking and rounding follow the reference.

Layouts (as the reference):
  q:      (B, S, H,  hd)
  k, v:   (B, T, KV, hd)     T = key length (cache capacity)
  output: (B, S, H,  hd)
GQA: H = KV * G; q reshapes to (B, S, KV, G, hd) so KV is never duplicated.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: avoids NaN from 0*inf

_CHUNK = 512  # key-block size for the online-softmax path


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_positions: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  *, causal: bool = True) -> torch.Tensor:
    """Grouped-query attention over an absolute-position KV buffer.

    q_positions: (B, S) int — absolute position of each query token.
    kv_valid_len: (B,) int — valid keys per row (None = all T valid).
    causal: query at position p attends keys at cache indices <= p.

    Key buffers longer than ``_CHUNK`` take the chunked online-softmax
    path, which holds one (B, KV, G, S, chunk) score block at a time."""
    T = k.shape[1]
    chunk = next((c for c in (_CHUNK, 256, 128) if T % c == 0), None)
    if T > _CHUNK and chunk is not None:
        return _gqa_chunked(q, k, v, q_positions, kv_valid_len,
                            causal=causal, chunk=chunk)
    return _gqa_dense(q, k, v, q_positions, kv_valid_len, causal=causal)


def _mask(q_positions, kv_valid_len, key_idx, causal):
    """(B, S, T) bool: which keys each query may attend."""
    B, S = q_positions.shape
    mask = torch.ones((B, S, key_idx.shape[0]), dtype=torch.bool,
                      device=q_positions.device)
    if causal:
        mask = key_idx[None, None, :] <= q_positions[:, :, None]
    if kv_valid_len is not None:
        mask = mask & (key_idx[None, None, :] < kv_valid_len[:, None, None])
    return mask


def _gqa_dense(q, k, v, q_positions, kv_valid_len, *, causal):
    B, S, H, hd = q.shape
    _, T, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qf = q.float().reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) * scale
    key_idx = torch.arange(T, dtype=torch.int32, device=q.device)
    mask = _mask(q_positions, kv_valid_len, key_idx, causal)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _gqa_chunked(q, k, v, q_positions, kv_valid_len, *, causal, chunk):
    """Online softmax over key blocks. Operands widen to float32 block by
    block: the reference keeps them in storage dtype with f32 MXU
    accumulation, which is the same arithmetic (bf16 products are exact in
    f32)."""
    B, S, H, hd = q.shape
    _, T, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qr = q.float().reshape(B, S, KV, G, hd)
    dev = q.device
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, S, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KV, G, S, 1), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for i in range(T // chunk):
        kb = k[:, i * chunk:(i + 1) * chunk].float()
        vb = v[:, i * chunk:(i + 1) * chunk].float()
        scores = torch.einsum("bskgh,btkh->bkgst", qr, kb) * scale
        key_idx = i * chunk + torch.arange(chunk, dtype=torch.int32,
                                           device=dev)
        maskb = _mask(q_positions, kv_valid_len, key_idx,
                      causal)[:, None, None, :, :]
        scores = torch.where(maskb, scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        # explicit zeroing (not exp of NEG-NEG): a fully-masked block
        # would otherwise contribute exp(0)=1 per masked key
        p = torch.where(maskb, torch.exp(scores - m_new),
                        torch.zeros((), dtype=torch.float32, device=dev))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkh->bkgsh", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    # (B, KV, G, S, hd) -> (B, S, H, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
