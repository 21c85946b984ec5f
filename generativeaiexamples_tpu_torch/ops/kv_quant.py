"""Per-row symmetric int8 quantization for the paged KV cache (port of the
reference's ``ops/kv_quant.py``).

One symmetric scale per cached row (per token, per kv head, per layer)
over the head dim:

    scale = max|row| / 127        (stored bf16)
    q     = clip(round(row / scale), -127, 127)   int8

The scale is cast to bf16 BEFORE the division, so quantization and
dequantization use the same value. ``torch.round`` rounds half to even,
as ``jnp.round`` does, so the two packages give the same bytes. The
int8-KV decode kernel (``csrc/paged_attention.cu``) quantizes its
appended row with the same arithmetic, so appended rows and rows inserted
from a prefill bucket are bit-identical.

Scale-pool layout: ``(L, N, KV, page)`` bf16 beside the int8 pools'
``(L, N, KV, page, hd)``.
"""

from __future__ import annotations

import torch

SCALE_DTYPE = torch.bfloat16
QMAX = 127.0


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` per row over its last axis. Returns ``(q, scale)``:
    ``q`` int8 shaped like ``x`` and ``scale`` bf16 shaped
    ``x.shape[:-1]``, with ``q * scale ~= x``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = (amax.clamp_min(1e-8) / QMAX).to(SCALE_DTYPE)
    q = torch.clamp(torch.round(xf / scale.float()[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (scale broadcast over the last
    axis)."""
    return (q.float() * scale.float()[..., None]).to(dtype)
