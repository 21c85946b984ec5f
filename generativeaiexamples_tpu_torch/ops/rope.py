"""Rotary position embeddings, HF ``rotate_half`` (non-interleaved)
layout — port of the reference's ``ops/rope.py``."""

from __future__ import annotations

from typing import Union

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     scaling_factor: float = 1.0,
                     device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32.
    ``scaling_factor > 1`` is linear RoPE scaling."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    return inv_freq / scaling_factor


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q (..., S, H, hd) and k (..., S, KV, hd) by the angles of
    ``positions`` (..., S): the head dim splits into halves (x1, x2) ->
    (x1*cos - x2*sin, x2*cos + x1*sin), computed in float32."""
    angles = positions[..., None].float() * inv_freq   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]              # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]

    def rot(x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.float().chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)
