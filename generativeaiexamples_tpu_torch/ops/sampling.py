"""Token sampling and the packed vocab bitfields — port of the reference's
``ops/sampling.py``.

Seen/banned vocab masks live packed, 32 tokens per word (bit i of word w
covers token w*32+i), exactly the reference's uint32 layout. PyTorch's
uint32 dtype lacks shift/bitwise kernels on some builds, so the port keeps
each word's unsigned 32-bit value in an int64 element: the values equal
the reference's words, only the storage width differs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
MASK_BITS = 32
WORD_DTYPE = torch.int64


def mask_words(vocab_size: int) -> int:
    """Words needed to cover ``vocab_size`` mask bits."""
    return -(-vocab_size // MASK_BITS)


def _bit_weights(device) -> torch.Tensor:
    return torch.ones((), dtype=WORD_DTYPE, device=device) << torch.arange(
        MASK_BITS, dtype=WORD_DTYPE, device=device)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(…, V) bool -> (…, ceil(V/32)) words. Tokens past V pad with 0."""
    V = mask.shape[-1]
    Wn = mask_words(V)
    pad = Wn * MASK_BITS - V
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    bits = mask.reshape(*mask.shape[:-1], Wn, MASK_BITS).to(WORD_DTYPE)
    return (bits * _bit_weights(mask.device)).sum(dim=-1)


def pack_mask_np(mask: np.ndarray) -> np.ndarray:
    """numpy twin of pack_mask for host-side mask rendering."""
    V = int(mask.shape[-1])
    Wn = mask_words(V)
    padded = np.zeros(mask.shape[:-1] + (Wn * MASK_BITS,), bool)
    padded[..., :V] = mask
    bits = padded.reshape(*mask.shape[:-1], Wn, MASK_BITS)
    weights = np.int64(1) << np.arange(MASK_BITS, dtype=np.int64)
    return (bits.astype(np.int64) * weights).sum(-1)


def unpack_mask(words: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(…, Wn) words -> (…, vocab_size) bool."""
    shifts = torch.arange(MASK_BITS, dtype=WORD_DTYPE, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    flat = bits.reshape(*words.shape[:-1], -1)
    return flat[..., :vocab_size].bool()


def set_token_bits(words: torch.Tensor, tokens: torch.Tensor,
                   on: torch.Tensor) -> torch.Tensor:
    """Set each row's ``tokens[b]`` bit where ``on[b]``; rows with
    on=False are untouched. words: (B, Wn), tokens/on: (B,). Returns a
    new tensor."""
    rows = torch.arange(words.shape[0], device=words.device)
    wi = (tokens // MASK_BITS).long()
    bit = on.to(WORD_DTYPE) << (tokens % MASK_BITS).to(WORD_DTYPE)
    out = words.clone()
    out[rows, wi] = words[rows, wi] | bit
    return out


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample next tokens.

    logits:      (B, V) float
    temperature: (B,) — <= 0 means greedy
    top_k:       (B,) int — <= 0 means unlimited
    top_p:       (B,) float — <= 0 or >= 1 means unlimited
    Returns (B,) int32 ids. The draw is Gumbel-max over the kept logits
    (the reference's ``jax.random.categorical``), with noise from
    ``generator``; the two frameworks' random streams differ, so sampled
    draws agree in distribution, not sample by sample."""
    B, V = logits.shape
    dev = logits.device
    lf = logits.float()
    greedy_ids = lf.argmax(dim=-1).to(torch.int32)

    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = lf / temp
    sort_idx = torch.argsort(-scaled, dim=-1)                  # (B, V)
    ranks = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, torch.arange(V, device=dev).expand(B, V).contiguous())
    k = torch.where(top_k[:, None] <= 0, torch.full_like(top_k[:, None], V),
                    top_k[:, None])
    keep = ranks < k

    # top-p: keep the smallest prefix of sorted probs with cumsum >= p;
    # the token at sorted position j survives if the mass before it < p.
    sorted_logits = torch.gather(scaled, 1, sort_idx)
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    tp = top_p.float()[:, None]
    p = torch.where((tp <= 0) | (tp >= 1.0), torch.ones_like(tp), tp)
    sorted_keep_p = (cum - sorted_probs) < p
    keep_p = torch.zeros_like(keep).scatter_(1, sort_idx, sorted_keep_p)

    masked = torch.where(keep & keep_p, scaled,
                         torch.full_like(scaled, NEG_INF))
    u = torch.rand((B, V), generator=generator, device=dev,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    sampled = (masked + gumbel).argmax(dim=-1).to(torch.int32)

    is_greedy = (temperature <= 0) | (top_k == 1)
    return torch.where(is_greedy, greedy_ids, sampled)


def seen_mask(token_history: torch.Tensor, valid_len: torch.Tensor,
              vocab_size: int) -> torch.Tensor:
    """(B, V) bool mask of tokens present in each row's valid history.
    token_history: (B, T) int, valid_len: (B,)."""
    B, T = token_history.shape
    dev = token_history.device
    pos_valid = (torch.arange(T, device=dev)[None, :]
                 < valid_len[:, None]).to(torch.int8)
    seen = torch.zeros((B, vocab_size), dtype=torch.int8, device=dev)
    seen.scatter_reduce_(1, token_history.long(), pos_valid, reduce="amax")
    return seen.bool()


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """CTRL-style repetition penalty over already-seen tokens.
    seen: (B, V) bool, penalty: (B,) — 1.0 is a no-op."""
    pen = penalty[:, None].float()
    lf = logits.float()
    penalized = torch.where(lf > 0, lf / pen, lf * pen)
    return torch.where(seen, penalized, lf).to(logits.dtype)
